"""`python -m clp_tpu_torch`: the clp command line (cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's CPU tests: the repository root on sys.path, and one
torch thread (this host's CPU LAPACK hangs in batched 175 x 175 LU factors
with two to four threads; one thread or the default count is sound)."""

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)

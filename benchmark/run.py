"""Run one cell of BENCHMARK.json once on an NVIDIA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1

Prints the result as the last line of standard output and the numbers
compared, each beside its limit, as the last lines of standard error. Exits
2, printing no result, without a CUDA card (or with fewer than the cell
asks for), and 3 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# build and kernel caches inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], T0))

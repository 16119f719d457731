"""Thread settings of a worker process that runs the port's tests.

Every port test module that imports the JAX package calls
`set_worker_threads()` at import, so the settings hold in each pytest
worker that collects one: two torch threads, and one thread for numpy's
and scipy's OpenBLAS. pytest-xdist workers collect every module before
they run a test, so in a run of the whole suite with xdist the settings
also hold for the JAX package's tests, on purpose: OpenBLAS starts a
thread per core, and those threads busy-wait between calls, so beside a
few BLAS-heavy tests in other workers the single-threaded wall-clock bars
(the structure-detection times of test_round5_fixes.py) fail for want of
CPU, not for slow code (ROADMAP.md queue 3). One BLAS thread gives the
same results. A run without xdist shares no CPU between test files and
needs no cap.
"""

import scipy.linalg  # noqa: F401 — loads scipy's own OpenBLAS so the cap reaches it
import torch
from threadpoolctl import threadpool_limits


def set_worker_threads() -> None:
    torch.set_num_threads(2)
    threadpool_limits(limits=1, user_api="blas")

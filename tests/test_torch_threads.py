"""The thread settings of the port's test workers (tests/worker_threads.py)."""

import numpy as np
import torch
from threadpoolctl import threadpool_info

from tests.worker_threads import set_worker_threads

set_worker_threads()


def _blas_pools(owner):
    return [p for p in threadpool_info()
            if p["user_api"] == "blas" and f"{owner}.libs" in p["filepath"]]


def test_numpy_and_scipy_blas_capped_to_one_thread():
    pools = _blas_pools("numpy") + _blas_pools("scipy")
    assert pools, "no OpenBLAS of numpy or scipy is loaded"
    assert all(p["num_threads"] == 1 for p in pools), pools


def test_blas_results_unchanged_by_the_cap():
    # the cap changes how BLAS splits its work, not what it computes
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 48))
    b = rng.standard_normal((48, 32))
    ref = np.einsum("ik,kj->ij", a, b)
    np.testing.assert_allclose(a @ b, ref, rtol=1e-12, atol=1e-12)
    assert torch.get_num_threads() == 2

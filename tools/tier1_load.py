"""Host load in the tier-1 suite, as the two host-timing tests of
tests/test_round5_fixes.py feel it.

    JAX_PLATFORMS=cpu python tools/tier1_load.py cores tests/test_torch_crash.py
    JAX_PLATFORMS=cpu python tools/tier1_load.py detect 40

`cores FILE` runs one test file alone in one process and prints its wall
and the average number of cores it kept busy (user + system time over
wall). `detect SECONDS` repeats the two two-stage probes those tests time
(their 2 s bound) for SECONDS and prints the median and largest time of
each; start a test file beside it to see the load it adds.
"""

import os
import pathlib
import resource
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def cores(path: str) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "pytest", path, "-q", "-p", "no:cacheprovider",
                    "-n", "0"], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL, check=False)
    wall = time.time() - t0
    r = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(f"{path}: wall {wall:.1f} s, user {r.ru_utime:.1f} s, sys {r.ru_stime:.1f} s, "
          f"{(r.ru_utime + r.ru_stime) / wall:.2f} cores on average")


def detect(seconds: float) -> None:
    import numpy as np
    import scipy.sparse as sp

    sys.path.insert(0, str(ROOT))
    import tests.conftest  # noqa: F401  (the suite's JAX set-up)
    from clp_tpu.model import Model
    from clp_tpu.structure import detect_two_stage
    from tests.test_round5_fixes import _two_stage_model

    pos = _two_stage_model(S=256, m2=320, n1=32, n2=480, nnz_per_row=8)
    rng = np.random.default_rng(3)
    A = sp.random(2000, 6000, density=0.05, random_state=rng, format="csc")
    neg = Model()
    neg.load_problem(A, np.zeros(6000), np.full(6000, np.inf), np.ones(6000),
                     np.full(2000, -np.inf), np.ones(2000))
    times = {"positive": [], "negative": []}
    end = time.time() + seconds
    while time.time() < end:
        for name, model, kw in (("positive", pos, {"max_bytes": 1 << 34}),
                                ("negative", neg, {})):
            t0 = time.time()
            detect_two_stage(model, **kw)
            times[name].append(time.time() - t0)
    for name, ts in times.items():
        print(f"{name} probe: {len(ts)} runs, median {np.median(ts):.2f} s, "
              f"largest {max(ts):.2f} s")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "cores":
        cores(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "detect":
        detect(float(sys.argv[2]))
    else:
        sys.exit(__doc__)

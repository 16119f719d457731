"""A/B timing of the port's kernels (K1, K2, K3) in two checkouts, on one card.

    python3 kernel_ab.py OTHER_CHECKOUT [--rounds N]

OTHER_CHECKOUT is another checkout of this repository, for example a parent
commit unpacked with `git archive` into a git-ignored directory. Each
checkout's own `chip_smoke.check_k1`, `check_k3`, `check_k2` (m = 2048) and
its check of K2 at the wide m = 16,384 (`check_k2_wide`; older checkouts
name it `check_k2_above_limit`) build that checkout's kernels from its
sources, hold them against their plain versions and time them; here each
runs in a fresh process, in the order this, other, other, this for every
round, with `chip_smoke.cold_ms` replaced by a timing under each of three
L2 states before every launch:

- "dirty": 64 MB zeroed, as `chip_smoke.cold_ms` flushes. The L2 is then
  full of dirty lines, which the timed kernel writes back as it reads.
- "clean": 128 MB read. The L2 holds clean lines that a read evicts freely.
- "warm": no flush. What the previous launch read stays in the 50 MB L2
  where it fits (K3's 7 MB W and K2's 16.8 MB binv at m = 2048 do, K1's
  55 MB G and K2's 1.07 GB binv at m = 16,384 do not).

Each time is the median over chip_smoke.REPS launches on a busy stream,
beside the same timing of an empty launch (`torch.cuda._sleep(0)`), the
device-side floor of any kernel. Prints one JSON line per process and the
card's name and power limit. Imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

STATES = ("dirty", "clean", "warm")


def measure(tree: str) -> dict:
    """In this process: time `tree`'s K1, K3 and K2 under every L2 state."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    dirty = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    clean = torch.ones(32 << 20, dtype=torch.int32, device=dev)
    flushes = {"dirty": dirty.zero_, "clean": clean.sum, "warm": lambda: None}

    def timer(flush):
        def cold_ms(fn, _flush, busy=True):
            for _ in range(3):
                fn()
            times = []
            for _ in range(cs.REPS):
                flush()
                if busy:
                    torch.cuda._sleep(cs.BUSY_CYCLES)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            return statistics.median(times)
        return cold_ms

    G32 = cs.staircase_g32(dev)
    blocks = cs.staircase_blocks(dev, G32)
    wide = getattr(cs, "check_k2_wide", None) or cs.check_k2_above_limit
    res = {"tree": tree}
    for state in STATES:
        cs.cold_ms = timer(flushes[state])
        k1 = cs.check_k1(dev, dirty, G32)
        k3 = cs.check_k3(dev, dirty, *blocks)
        k2 = cs.check_k2(dev, dirty, G32)
        k2w = wide(dev, dirty, 16384)
        res[state] = {"K1_ms": k1["ms"], "K1_wrapper_ms": k1["wrapper_ms"],
                      "K3_ms": k3["ms"], "K3_wrapper_ms": k3["wrapper_ms"],
                      "K2_ms": k2["ms"], "K2_wrapper_ms": k2["wrapper_ms"],
                      "K2_16384_ms": k2w["ms"],
                      "floor_ms": cs.cold_ms(lambda: torch.cuda._sleep(0), dirty)}
    return res


def main(argv) -> int:
    if len(argv) not in (1, 3) or (len(argv) == 3 and argv[1] != "--rounds"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    this = str(pathlib.Path(__file__).resolve().parent)
    other = str(pathlib.Path(argv[0]).resolve())
    rounds = int(argv[2]) if len(argv) == 3 else 1
    for _ in range(rounds):
        for tree in (this, other, other, this):
            out = subprocess.run([sys.executable, __file__, "--measure", tree], cwd=tree,
                                 check=True, capture_output=True, text=True, timeout=600)
            print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))

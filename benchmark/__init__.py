"""The benchmark of clp_tpu_torch, the PyTorch and CUDA port, on NVIDIA cards.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1`
runs one cell of BENCHMARK.json once. README.md says what lives where.
"""

"""Device compute: the basis refactorization and the hand-written CUDA
kernels K1 (price.py) and K2 (pivot.py), each beside its plain PyTorch
version. Sources live in ../csrc and are built at first use (build.py)."""

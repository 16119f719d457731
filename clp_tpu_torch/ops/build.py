"""Build and load the port's hand-written CUDA kernels.

Each source `clp_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface and loaded
with ctypes (no PyTorch headers, so a build takes seconds). Libraries go
to `build/` at the repository root, named by a hash of their source, the
`csrc/*.cuh` headers and the flags, so a changed source is rebuilt and a
stale library is never loaded (`start` / `finish` do the same for the
g++ builds of `io/native.py`). Nothing is
built when a module is imported: the first launch builds, or a caller
builds every kernel at once with `build_all`, one `nvcc` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class BuildError(subprocess.CalledProcessError):
    """A compiler that exited with an error; its text carries the output."""

    def __str__(self) -> str:
        return f"{self.cmd[0]} exited {self.returncode}:\n{self.output}"


def lib_path(stem: str, sources, flags, hashed=()) -> pathlib.Path:
    """build/lib<stem>-<hash>.so, the hash taken over `sources`, `hashed`
    (headers they include) and `flags`."""
    src = b"".join(pathlib.Path(p).read_bytes() for p in [*sources, *hashed])
    digest = hashlib.sha1(src + " ".join(map(str, flags)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def start(stem: str, compiler, sources, flags, libs=(), hashed=()):
    """Start `compiler flags -o <tmp> sources libs` unless the library is
    built; `compiler` is a path or a callable giving one, asked only when a
    build is needed. Returns (library path, process, tmp path); the process
    is None when the library was already built."""
    out = lib_path(stem, sources, [*flags, *libs], hashed)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler() if callable(compiler) else compiler, *flags, "-o", str(tmp),
           *map(str, sources), *libs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def finish(started) -> str:
    """Wait for a build from `start`; returns the compiler's output, raises
    BuildError when it failed."""
    out, proc, tmp = started
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise BuildError(proc.returncode, proc.args, output=log)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return log


def _start(name: str):
    """Start nvcc for `csrc/<name>.cu` (the `csrc/*.cuh` headers count as
    part of it)."""
    return start(name, nvcc_path, [CSRC / f"{name}.cu"], [*NVCC_FLAGS, "-Xptxas", "-v"],
                 hashed=sorted(CSRC.glob("*.cuh")))


def build_all(names) -> dict[str, str]:
    """Build every named kernel in parallel; returns nvcc's log per name."""
    started = {n: _start(n) for n in names}
    return {n: finish(s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        finish(started)
        lib = ctypes.CDLL(str(started[0]))
        _loaded[name] = lib
    return lib

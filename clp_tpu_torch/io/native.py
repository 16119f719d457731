"""ctypes binding to the native C++ MPS parser (clp_tpu_torch/native/mps_parser.cpp).

The library is built with g++ at first use into `build/` at the repository
root, named by a hash of its source and flags, so a changed source is
rebuilt and a stale library never loaded. `read_mps_native` returns None
for what the C++ parser does not read (gzip input, a QUADOBJ section) and
the caller takes the Python reader; a failed build makes `available()`
False. The C API (`clp_c_api.cpp`, which embeds CPython and drives this
package) is built by `build_capi` the same way.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sysconfig
from typing import Optional

import numpy as np

from ..ops import build

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
CXX = "g++"
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _build(stem: str, sources: list[str], libs: list[str]) -> pathlib.Path:
    """g++ the .cpp files of `sources` (under native/; headers count in the
    hash) into build/lib<stem>-<hash>.so through `ops.build`; returns the
    library's path. Raises `build.BuildError` (a CalledProcessError) when
    the compiler fails, FileNotFoundError without it."""
    paths = [NATIVE_DIR / s for s in sources]
    started = build.start(stem, CXX, [p for p in paths if p.suffix == ".cpp"], CXXFLAGS,
                          libs=libs, hashed=[p for p in paths if p.suffix != ".cpp"])
    build.finish(started)
    return started[0]


def build_capi() -> pathlib.Path:
    """Build the C API (`libclptpu_capi`) against this interpreter's
    libpython; returns the library's path. A C client compiles with
    `-I clp_tpu_torch/native` and links this file."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_python_version()
    return _build("clptpu_capi", ["clp_c_api.cpp", "ClpTpu_C_Interface.h"],
                  [f"-I{inc}", f"-I{NATIVE_DIR}", f"-L{libdir}",
                   f"-Wl,-rpath,{libdir}", f"-lpython{ver}", "-lm"])


class _ClpTpuMps(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("row_lower", ctypes.POINTER(ctypes.c_double)),
        ("row_upper", ctypes.POINTER(ctypes.c_double)),
        ("col_lower", ctypes.POINTER(ctypes.c_double)),
        ("col_upper", ctypes.POINTER(ctypes.c_double)),
        ("obj", ctypes.POINTER(ctypes.c_double)),
        ("ai", ctypes.POINTER(ctypes.c_int64)),
        ("aj", ctypes.POINTER(ctypes.c_int64)),
        ("av", ctypes.POINTER(ctypes.c_double)),
        ("obj_offset", ctypes.c_double),
        ("maximize", ctypes.c_int32),
        ("names_blob", ctypes.POINTER(ctypes.c_char)),
        ("names_blob_len", ctypes.c_int64),
        ("row_name_off", ctypes.POINTER(ctypes.c_int64)),
        ("col_name_off", ctypes.POINTER(ctypes.c_int64)),
        ("problem_name", ctypes.c_char * 256),
        ("n_integer", ctypes.c_int64),
        ("integer_idx", ctypes.POINTER(ctypes.c_int64)),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        path = _build("clptpu_native", ["mps_parser.cpp"], ["-lm"])
        lib = ctypes.CDLL(str(path))
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return None  # no compiler, a failed build or an unloadable library
    lib.clptpu_read_mps.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ClpTpuMps)]
    lib.clptpu_read_mps.restype = ctypes.c_int
    lib.clptpu_free_mps.argtypes = [ctypes.POINTER(_ClpTpuMps)]
    lib.clptpu_free_mps.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_mps_native(filename: str, into=None, keep_names: bool = True):
    """Parse via the C++ core; returns None if unavailable/unsupported."""
    lib = _load()
    if lib is None:
        return None
    if filename.endswith(".gz"):
        return None  # gzip handled by the Python path
    res = _ClpTpuMps()
    rc = lib.clptpu_read_mps(filename.encode(), ctypes.byref(res))
    if rc == 1:
        raise FileNotFoundError(filename)
    if rc != 0:
        return None  # parse issue or unsupported section: fall back
    try:
        import scipy.sparse as sp

        from ..model import Model

        m, n, nnz = res.n_rows, res.n_cols, res.nnz
        model = into if into is not None else Model()

        def arr(ptr, count, dtype):
            if count == 0:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)

        ai = arr(res.ai, nnz, np.int64)
        aj = arr(res.aj, nnz, np.int64)
        av = arr(res.av, nnz, np.float64)
        A = sp.coo_matrix((av, (ai, aj)), shape=(m, n)).tocsc()
        A.sum_duplicates()
        model.load_problem(
            A,
            arr(res.col_lower, n, np.float64),
            arr(res.col_upper, n, np.float64),
            arr(res.obj, n, np.float64),
            arr(res.row_lower, m, np.float64),
            arr(res.row_upper, m, np.float64),
        )
        model.objective_offset = float(res.obj_offset)
        model.optimization_direction = -1.0 if res.maximize else 1.0
        model.problem_name = res.problem_name.decode()
        if keep_names and res.names_blob_len:
            blob = ctypes.string_at(res.names_blob, res.names_blob_len)
            roff = arr(res.row_name_off, m, np.int64)
            coff = arr(res.col_name_off, n, np.int64)

            def name_at(off):
                end = blob.index(b"\x00", off)
                return blob[off:end].decode()

            model.row_names = [name_at(o) for o in roff]
            model.col_names = [name_at(o) for o in coff]
        if res.n_integer:
            mask = np.zeros(n, dtype=bool)
            mask[arr(res.integer_idx, res.n_integer, np.int64)] = True
            model.integer_mask = mask
        return model
    finally:
        lib.clptpu_free_mps(ctypes.byref(res))

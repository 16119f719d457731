"""Port parity of the model files: MPS basis, LP format, AMPL .nl and .sol,
and the native C++ MPS parser route (clp_tpu_torch vs clp_tpu, CPU).

Each writer must put out the bytes the JAX package's writes for the same
model, and each reader must read back the arrays the JAX package's reads."""

import shutil

import numpy as np
import pytest
import scipy.sparse as sp

import clp_tpu
from clp_tpu.io import basis as jbasis
from clp_tpu.io import lp_format as jlp
from clp_tpu.io import nl as jnl
from clp_tpu.io.mps import read_mps as jax_read_mps
from clp_tpu.utils import generators as jgen

import clp_tpu_torch
from clp_tpu_torch.constants import INF, ProblemStatus, SolveMethod
from clp_tpu_torch.io import basis, lp_format, native, nl
from clp_tpu_torch.io.mps import read_mps, write_mps
from tests.test_mps_edge import EDGE
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

_ARRAYS = ("col_lower", "col_upper", "objective", "row_lower", "row_upper")


def assert_same_model(a, b):
    """Same arrays, matrix, sense, offset and names, bit for bit."""
    check = np.testing.assert_array_equal
    assert a.matrix.shape == b.matrix.shape
    check(a.matrix.toarray(), b.matrix.toarray())
    for f in _ARRAYS:
        check(getattr(a, f), getattr(b, f))
    assert a.optimization_direction == b.optimization_direction
    assert a.objective_offset == b.objective_offset
    assert list(a.col_names or []) == list(b.col_names or [])
    assert list(a.row_names or []) == list(b.row_names or [])


def _named(mj):
    """A JAX model with row and column names, a maximize sense, an offset,
    a ranged row, a free column and an integer column."""
    mj.col_names = [f"x{j}" for j in range(mj.num_cols)]
    mj.row_names = [f"r{i}" for i in range(mj.num_rows)]
    mj.optimization_direction = -1.0
    mj.objective_offset = 2.5
    mj.row_lower = mj.row_lower.copy()
    mj.row_upper = mj.row_upper.copy()
    mj.row_lower[0], mj.row_upper[0] = -3.0, 7.0
    mj.col_lower = mj.col_lower.copy()
    mj.col_upper = mj.col_upper.copy()
    mj.col_lower[1], mj.col_upper[1] = -clp_tpu.INF, clp_tpu.INF
    mj.integer_mask = np.zeros(mj.num_cols, dtype=bool)
    mj.integer_mask[2] = True
    return mj


def _both(mj):
    mt = port_model(mj)
    mt.col_names, mt.row_names = list(mj.col_names), list(mj.row_names)
    mt.integer_mask = None if mj.integer_mask is None else mj.integer_mask.copy()
    return mt


@pytest.mark.parametrize("seed", [0, 1])
def test_basis_file_bytes_and_round_trip(tmp_path, seed):
    mj = jgen.random_lp(12, 20, seed=seed)
    mj.col_names = [f"c{j}" for j in range(20)]
    mj.row_names = [f"r{i}" for i in range(12)]
    o = clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX)
    o.presolve.enabled = False
    mj.initial_solve(o)
    mt = _both(mj)
    mt.solution = clp_tpu_torch.Solution(column_status=mj.solution.column_status.copy(),
                                         row_status=mj.solution.row_status.copy())
    pj, pt = tmp_path / "j.bas", tmp_path / "t.bas"
    assert jbasis.write_basis(mj, str(pj)) == 0
    assert basis.write_basis(mt, str(pt)) == 0
    assert pt.read_bytes() == pj.read_bytes()
    back_j, back_t = _both(mj), _both(mj)
    jbasis.read_basis(back_j, str(pj))
    assert basis.read_basis(back_t, str(pt)) == 0
    np.testing.assert_array_equal(back_t.solution.column_status,
                                  back_j.solution.column_status)
    np.testing.assert_array_equal(back_t.solution.row_status, back_j.solution.row_status)
    assert back_t.warm_start_pending
    assert basis.read_basis(back_t, str(tmp_path / "missing.bas")) == -1


@pytest.mark.parametrize("make", [lambda: jgen.random_lp(8, 14, seed=3),
                                  lambda: jgen.staircase_lp(3, 8, 12, seed=1)],
                         ids=["random", "staircase"])
def test_lp_format_bytes_and_round_trip(tmp_path, make):
    mj = _named(make())
    mt = _both(mj)
    pj, pt = tmp_path / "j.lp", tmp_path / "t.lp"
    jlp.write_lp(mj, str(pj))
    lp_format.write_lp(mt, str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    rj = jlp.read_lp(str(pj))
    rt = lp_format.read_lp(str(pt))
    assert_same_model(rt, rj)
    np.testing.assert_array_equal(rt.integer_mask, rj.integer_mask)
    # Model.read_lp reads in place and reports a missing file
    m = clp_tpu_torch.Model()
    assert m.read_lp(str(pt)) == 0 and m.num_rows == rj.num_rows
    assert clp_tpu_torch.Model().read_lp(str(tmp_path / "missing.lp")) == -1


def test_lp_format_round_trip_solves_like_jax(tmp_path):
    mj = jgen.random_lp(6, 10, seed=3)
    mt = port_model(mj)
    p = str(tmp_path / "m.lp")
    clp_tpu_torch.write_lp(mt, p)
    back = clp_tpu_torch.read_lp(p)
    st = back.initial_solve(clp_tpu_torch.SolveOptions(method=SolveMethod.DUAL_SIMPLEX,
                                                       device="cpu"))
    sj = mj.initial_solve(clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX))
    assert st.status == ProblemStatus.OPTIMAL
    assert abs(st.objective_value - sj.objective_value) <= 1e-9 * (1 + abs(sj.objective_value))


@pytest.mark.parametrize("sense", [1.0, -1.0])
def test_nl_bytes_and_round_trip(tmp_path, sense):
    mj = jgen.random_lp(9, 15, seed=5)
    mj.optimization_direction = sense
    mj.objective_offset = -1.25
    mt = port_model(mj)
    pj, pt = tmp_path / "j.nl", tmp_path / "t.nl"
    jnl.write_nl(mj, str(pj))
    nl.write_nl(mt, str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    rj = jnl.read_nl(str(pj))
    rt = nl.read_nl(str(pt))
    assert_same_model(rt, rj)
    # numbers are written in round-trip form: the model comes back exactly
    for f in _ARRAYS:
        np.testing.assert_array_equal(getattr(rt, f), getattr(mt, f))


def test_nl_sol_bytes(tmp_path):
    mj = jgen.random_lp(6, 9, seed=2)
    mj.initial_solve(clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX))
    mt = port_model(mj)
    sol = clp_tpu_torch.Solution(status=ProblemStatus(int(mj.solution.status)),
                                 objective_value=mj.solution.objective_value,
                                 primal=mj.solution.primal.copy(),
                                 duals=mj.solution.duals.copy())
    pj = jnl.write_sol(str(tmp_path / "j"), mj, mj.solution)
    pt = nl.write_sol(str(tmp_path / "t"), mt, sol)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    bad = clp_tpu_torch.Solution(status=ProblemStatus.PRIMAL_INFEASIBLE)
    assert "objno 0 200" in open(nl.write_sol(str(tmp_path / "inf"), mt, bad)).read()
    with pytest.raises(nl.NLError):
        nl.read_nl(str(tmp_path / "j.sol"))


@needs_gxx
@pytest.mark.parametrize("make", [lambda: jgen.staircase_lp(4, 16, 36, seed=0),
                                  lambda: jgen.random_lp(15, 25, seed=9)],
                         ids=["staircase", "random"])
def test_native_reader_matches_python_reader(tmp_path, make):
    mj = make()
    mt = port_model(mj)
    mt.integer_mask = np.zeros(mt.num_cols, dtype=bool)
    mt.integer_mask[[1, 3]] = True
    p = str(tmp_path / "m.mps")
    write_mps(mt, p)
    assert native.available()
    mn = native.read_mps_native(p)
    assert mn is not None
    mp = read_mps(p, use_native=False)
    assert_same_model(mn, mp)
    np.testing.assert_array_equal(mn.integer_mask, mp.integer_mask)
    # and the JAX package's reader gives the same arrays
    assert_same_model(mn, jax_read_mps(p, use_native=False))
    # read_mps takes the native route by default
    assert_same_model(read_mps(p), mn)


@needs_gxx
def test_native_reader_on_the_edge_cases(tmp_path):
    p = tmp_path / "edge.mps"
    p.write_text(EDGE)
    mn = native.read_mps_native(str(p))
    assert mn is not None
    assert_same_model(mn, read_mps(str(p), use_native=False))
    crlf = tmp_path / "crlf.mps"
    crlf.write_bytes(EDGE.replace("    ", "\t", 3).replace("\n", "\r\n").encode())
    assert_same_model(read_mps(str(crlf)), read_mps(str(crlf), use_native=False))
    with pytest.raises(FileNotFoundError):
        read_mps(str(tmp_path / "missing.mps"))


def test_quadobj_falls_back_to_the_python_reader(tmp_path):
    m = clp_tpu_torch.Model()
    m.load_problem(sp.csc_matrix(np.array([[1.0, 1.0]])),
                   [0, 0], [INF, INF], [-1.0, -1.0], [-INF], [1.0])
    m.load_quadratic_objective(sp.eye(2, format="csc"))
    p = str(tmp_path / "qp.mps")
    write_mps(m, p)
    assert native.read_mps_native(p) is None
    back = read_mps(p)
    assert back.quadratic_objective is not None
    np.testing.assert_array_equal(back.quadratic_objective.toarray(), np.eye(2))


def test_failed_native_build_takes_the_python_reader(tmp_path, monkeypatch):
    """Only the build's own failures (no g++, a compiler error, an
    unloadable library) turn the native route off."""
    from clp_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    p = str(tmp_path / "m.mps")
    write_mps(port_model(jgen.random_lp(5, 7, seed=0)), p)
    # a compiler that exits 1, and none at all
    for compiler in ("false", str(tmp_path / "no-such-g++")):
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_lib_tried", False)
        monkeypatch.setattr(native, "CXX", compiler)
        assert not native.available()
        assert read_mps(p).num_rows == 5

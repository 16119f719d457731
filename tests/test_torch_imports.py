"""The PyTorch port stands alone: it imports neither jax nor clp_tpu."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "clp_tpu_torch"

_FORBIDDEN = [
    re.compile(r"^\s*import\s+jax\b", re.M),
    re.compile(r"^\s*from\s+jax\b", re.M),
    re.compile(r"\bclp_tpu\.(?!_)"),
    re.compile(r"\bfrom\s+clp_tpu\b(?!_)"),
    re.compile(r"\bimport\s+clp_tpu\b(?!_)"),
]


def _port_modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


# a Python module named in a string of the C++ sources (the C API embeds
# CPython and imports the package by name)
_CPP_MODULE = re.compile(r'"(clp_tpu\w*(?:\.\w+)*)"')


def test_native_sources_import_only_the_port():
    """The C API copy names only clp_tpu_torch and its modules."""
    sources = sorted((PORT / "native").glob("*.cpp"))
    assert sources
    named = set()
    for path in sources:
        for mod in _CPP_MODULE.findall(path.read_text()):
            named.add(mod)
            assert mod == "clp_tpu_torch" or mod.startswith("clp_tpu_torch."), (path, mod)
    assert {"clp_tpu_torch", "clp_tpu_torch.crash", "clp_tpu_torch.events"} <= named


@pytest.mark.parametrize("value, want", [(None, "cuda"), ("cpu", "cpu"), ("CPU", "cpu"),
                                         ("tpu", "cuda"), ("cuda", "cuda")])
def test_clptpu_platform_picks_the_default_device(monkeypatch, value, want):
    from clp_tpu_torch import SolveOptions
    from clp_tpu_torch.device import default_device

    if value is None:
        monkeypatch.delenv("CLPTPU_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("CLPTPU_PLATFORM", value)
    assert default_device() == want
    assert SolveOptions().device == want
    # an explicit device wins over the variable
    assert SolveOptions(device="cpu").device == "cpu"


def test_default_cuda_device_still_raises_without_a_card(monkeypatch):
    from clp_tpu_torch import SolveOptions, initial_solve, ranging
    from clp_tpu_torch.cli import CLI
    from clp_tpu_torch.osi import OsiClpTpuSolverInterface
    from clp_tpu_torch.utils.generators import random_lp

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-card path cannot be exercised")
    monkeypatch.delenv("CLPTPU_PLATFORM", raising=False)
    model = random_lp(5, 8, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        initial_solve(model, SolveOptions())
    with pytest.raises(RuntimeError, match="cuda"):
        CLI().model.dual()
    with pytest.raises(RuntimeError, match="cuda"):
        OsiClpTpuSolverInterface(model).initialSolve()
    monkeypatch.setenv("CLPTPU_PLATFORM", "cpu")
    model.dual()
    monkeypatch.delenv("CLPTPU_PLATFORM")
    with pytest.raises(RuntimeError, match="cuda"):
        ranging(model)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_clp_tpu_import_in_source(path):
    text = path.read_text()
    for pat in _FORBIDDEN:
        m = pat.search(text)
        assert m is None, f"{path}: forbidden reference {m.group(0)!r}"


def test_importing_the_port_loads_no_jax():
    mods = list(_port_modules()) + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'clp_tpu' or k.startswith('clp_tpu.')]\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_cuda_device_without_card_raises():
    from clp_tpu_torch import SolveOptions, initial_solve
    from clp_tpu_torch.constants import SolveMethod
    from clp_tpu_torch.forms import to_standard_form
    from clp_tpu_torch.simplex.driver import simplex_solve
    from clp_tpu_torch.utils.generators import random_lp

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-card path cannot be exercised")
    model = random_lp(5, 8, seed=1)
    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX)  # device="cuda" by default
    with pytest.raises(RuntimeError, match="cuda"):
        initial_solve(model, opts)
    with pytest.raises(RuntimeError, match="cuda"):
        to_standard_form(model)
    with pytest.raises(RuntimeError, match="cuda"):
        simplex_solve(model, opts, dual=True)
    with pytest.raises(RuntimeError, match="cuda"):
        model.dual()


def test_fp32_precision_guard():
    from clp_tpu_torch import SolveOptions, initial_solve
    from clp_tpu_torch.constants import SolveMethod
    from clp_tpu_torch.utils.generators import random_lp

    opts = SolveOptions(method=SolveMethod.DUAL_SIMPLEX, device="cpu")
    prev = torch.get_float32_matmul_precision()
    try:
        # "high" also turns allow_tf32 on: either check may fire first
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="highest|allow_tf32"):
            initial_solve(random_lp(5, 8, seed=1), opts)
    finally:
        torch.set_float32_matmul_precision(prev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            initial_solve(random_lp(5, 8, seed=1), opts)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


# the modules each slice added, which the two tests above must cover
SLICE_MODULES = ["clp_tpu_torch.simplex.qp", "clp_tpu_torch.dynamic",
                 "clp_tpu_torch.colgen", "clp_tpu_torch.piecewise", "clp_tpu_torch.slp",
                 "clp_tpu_torch.parallel.batch", "clp_tpu_torch.parallel.racing",
                 "clp_tpu_torch.decompose", "clp_tpu_torch.utils.prng",
                 "clp_tpu_torch.branching", "clp_tpu_torch.mip", "clp_tpu_torch.osi",
                 "clp_tpu_torch.params", "clp_tpu_torch.cli", "clp_tpu_torch.__main__",
                 "clp_tpu_torch.netlib", "clp_tpu_torch.io.basis",
                 "clp_tpu_torch.io.lp_format", "clp_tpu_torch.io.nl",
                 "clp_tpu_torch.io.native", "clp_tpu_torch.parallel.mesh",
                 "clp_tpu_torch.parallel.block", "clp_tpu_torch.parallel.colshard",
                 "clp_tpu_torch.parallel.dryrun", "clp_tpu_torch.utils.lockstep"]


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_slice_modules_are_checked(name):
    assert name in list(_port_modules())
    path = ROOT / (name.replace(".", "/") + ".py")
    assert path in _port_files()


@pytest.mark.parametrize("kw", [
    {"shape_bucket": 64},
    {"method": "SPRINT", "devices": ["cpu", "cpu"]},
    {"method": "BARRIER_NO_CROSS", "shape_bucket": 64},
], ids=["shape_bucket", "sprint-devices", "qp-shape_bucket"])
def test_unported_routes_raise(kw):
    """The routes that raised until the last slice of the port run and
    match the JAX package's: shape buckets on the simplex and on the QP
    barrier, and SPRINT given a plain list of devices (ignored by both
    packages' SPRINT, which takes a Mesh with a "block" axis only)."""
    import scipy.sparse as sp

    import clp_tpu
    from clp_tpu.utils.generators import random_lp as jax_random_lp

    from clp_tpu_torch import Model, SolveOptions, initial_solve
    from clp_tpu_torch.constants import SolveMethod

    method = kw.get("method", "DUAL_SIMPLEX")
    if method == "SPRINT":
        mj = jax_random_lp(6, 40, seed=2)
    else:
        mj = jax_random_lp(6, 9, seed=2)
    if method == "BARRIER_NO_CROSS":
        mj.load_quadratic_objective(sp.identity(mj.num_cols, format="csc"))
    mt = Model()
    mt.load_problem(mj.matrix, mj.col_lower, mj.col_upper, mj.objective,
                    mj.row_lower, mj.row_upper)
    if mj.quadratic_objective is not None:
        mt.load_quadratic_objective(mj.quadratic_objective)
    jkw = dict(kw, method=clp_tpu.SolveMethod[method])
    if "devices" in jkw:
        import jax

        jkw["devices"] = jax.devices()[:2]
    js = clp_tpu.initial_solve(mj, clp_tpu.SolveOptions(**jkw))
    ts = initial_solve(mt, SolveOptions(device="cpu", **dict(kw, method=SolveMethod[method])))
    assert int(ts.status) == int(js.status) == 0
    assert abs(ts.objective_value - js.objective_value) <= 1e-9 * (1 + abs(js.objective_value))
    assert ts.iterations == js.iterations
    assert ts.primal.shape == (mj.num_cols,)


@pytest.mark.parametrize("entry", ["solve_batch", "batch_dual", "batch_qp", "racing"])
def test_device_meshes_raise_multi_device(entry):
    """A device mesh, or a race over several devices, raised until the last
    slice of the port; now each runs on a 2-entry CPU mesh and matches the
    JAX package's run on 2 XLA CPU devices."""
    import jax
    import scipy.sparse as sp

    import clp_tpu
    from clp_tpu.parallel import batch as jb
    from clp_tpu.parallel import racing as jr
    from clp_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from clp_tpu.utils.generators import random_lp as jax_random_lp

    from clp_tpu_torch import Model, SolveOptions
    from clp_tpu_torch.parallel import batch, racing
    from clp_tpu_torch.parallel.mesh import make_mesh
    from clp_tpu_torch.solve import solve_batch

    jmodels = [jax_random_lp(6, 9, seed=2), jax_random_lp(6, 9, seed=3)]
    if entry == "batch_qp":
        for m in jmodels:
            m.load_quadratic_objective(sp.identity(m.num_cols, format="csc"))
    models = []
    for mj in jmodels:
        mt = Model()
        mt.load_problem(mj.matrix, mj.col_lower, mj.col_upper, mj.objective,
                        mj.row_lower, mj.row_upper)
        if mj.quadratic_objective is not None:
            mt.load_quadratic_objective(mj.quadratic_objective)
        models.append(mt)
    opts = SolveOptions(device="cpu")
    mesh, jmesh = make_mesh(["cpu", "cpu"]), jax_make_mesh(jax.devices()[:2])
    call = {
        "solve_batch": (lambda: solve_batch(models, opts, mesh=mesh),
                        lambda: clp_tpu.solve_batch(jmodels, mesh=jmesh)),
        "batch_dual": (lambda: batch.solve_batch_dual_simplex(models, opts, mesh=mesh),
                       lambda: jb.solve_batch_dual_simplex(jmodels, mesh=jmesh)),
        "batch_qp": (lambda: batch.solve_batch_qp_simplex(models, opts, mesh=mesh),
                     lambda: jb.solve_batch_qp_simplex(jmodels, mesh=jmesh)),
        "racing": (lambda: [racing.racing_solve(models[0], devices=["cpu", "cpu"])],
                   lambda: [jr.racing_solve(jmodels[0], devices=jax.devices()[:2])]),
    }[entry]
    tsols, jsols = call[0](), call[1]()
    # racing's winner may be the barrier without crossover in either package
    rel = 1e-6 if entry == "racing" else 1e-9
    for t, j in zip(tsols, jsols):
        assert int(t.status) == int(j.status) == 0
        assert abs(t.objective_value - j.objective_value) <= rel * (1 + abs(j.objective_value))


def test_ablate_gates_raise():
    """The timing-only gates are ported (they raised until the API/CLI
    slice): a solve with one runs, and the gate takes effect — with
    "update" the pivots change the basis but never binv."""
    from clp_tpu_torch.forms import to_standard_form
    from clp_tpu_torch.simplex import engine
    from clp_tpu_torch.utils.generators import random_lp

    lp, _ = to_standard_form(random_lp(12, 20, seed=5), device="cpu")
    opts = engine.SimplexOptions(ablate=("update",), max_iterations=3)
    st = engine.make_dual_feasible(lp, engine.recompute(lp, engine.initial_state(lp, opts),
                                                        opts.dual_bound), opts)
    out = engine.dual_iteration(lp, st, opts)
    assert int(out.iterations) == int(st.iterations) + 1
    assert not torch.equal(out.basis, st.basis)
    assert torch.equal(out.binv, st.binv)
    engine.dual_solve(lp, st, opts)  # runs: no gate is refused


def test_ablate_refuses_unknown_members():
    from clp_tpu_torch.simplex import engine

    with pytest.raises(ValueError, match="prce"):
        engine.SimplexOptions(ablate=("prce",))
    assert engine.SimplexOptions(ablate=tuple(engine.ABLATE_MEMBERS)).ablate


def test_cuda_wrappers_refuse_other_devices():
    from clp_tpu_torch.ops.pivot import fused_pivot_update
    from clp_tpu_torch.ops.price import price_and_ratios

    G = torch.zeros(4, 7, device="meta")
    v = torch.zeros(7, device="meta")
    with pytest.raises(ValueError):
        price_and_ratios(torch.zeros(4, device="meta"), G, v, v, v, 1.0, 0.0, 0.0)
    b = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError):
        fused_pivot_update(b, torch.zeros(4, 3, device="meta"),
                           torch.zeros(4, device="meta"), 1.0, 1.0, 0)

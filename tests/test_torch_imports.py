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


@pytest.mark.parametrize("kw, match", [
    ({"method": "AUTOMATIC"}, "AUTOMATIC"),
    ({"method": "BARRIER"}, "barrier"),
    ({"method": "PDLP"}, "other solvers"),
    ({"dual_pivot": "pesteepest"}, "pe"),
    ({"price_mode": "ell"}, "ell"),
    ({"shape_bucket": 64}, "shape_bucket"),
    ({"crash": "idiot"}, "crash"),
    ({"dualize": 1}, "dualize"),
])
def test_unported_routes_raise(kw, match):
    from clp_tpu_torch import SolveOptions, initial_solve
    from clp_tpu_torch.constants import SolveMethod
    from clp_tpu_torch.utils.generators import random_lp

    kw = dict(kw)
    kw["method"] = SolveMethod[kw.get("method", "DUAL_SIMPLEX")]
    with pytest.raises(NotImplementedError, match=match):
        initial_solve(random_lp(6, 9, seed=2), SolveOptions(device="cpu", **kw))


def test_ablate_gates_raise():
    from clp_tpu_torch.forms import to_standard_form
    from clp_tpu_torch.simplex import engine
    from clp_tpu_torch.utils.generators import random_lp

    lp, _ = to_standard_form(random_lp(6, 9, seed=2), device="cpu")
    opts = engine.SimplexOptions(ablate=("price",))
    st = engine.initial_state(lp, opts)
    with pytest.raises(NotImplementedError, match="ablate"):
        engine.dual_solve(lp, st, opts)


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

"""Port parity of the command line, its parameters, the Netlib harness and
the C API (clp_tpu_torch vs clp_tpu, CPU).

The port's CLI solves on `SolveOptions.device`, whose default follows
CLPTPU_PLATFORM: these tests set it to "cpu", in-process with monkeypatch
and in the environment of each subprocess."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import clp_tpu
from clp_tpu import params as jparams
from clp_tpu.cli import CLI as JaxCLI
from clp_tpu.utils import generators as jgen

from clp_tpu_torch import params
from clp_tpu_torch.cli import CLI, main
from clp_tpu_torch.constants import ProblemStatus
from clp_tpu_torch.io import native
from clp_tpu_torch.netlib import GOLDEN, run_netlib
from tests.test_torch_qp import port_model
from tests.worker_threads import set_worker_threads

set_worker_threads()

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("CLPTPU_PLATFORM", "cpu")


def _env():
    env = dict(os.environ, CLPTPU_PLATFORM="cpu", CLPTPU_ROOT=str(ROOT))
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in sys.path if p])
    return env


def _staircase_mps(tmp_path, name="s.mps"):
    m = port_model(jgen.staircase_lp(4, 16, 36, seed=0))
    m.col_names = [f"C{j}" for j in range(m.num_cols)]
    m.row_names = [f"R{i}" for i in range(m.num_rows)]
    p = str(tmp_path / name)
    m.write_mps(p)
    return p


def _as_jax(text: str) -> str:
    # the one difference: the port's help names its own library module
    # (decomposeBlocks: "library: clp_tpu_torch.decompose")
    return text.replace("clp_tpu_torch.", "clp_tpu.")


def test_params_parity_table_and_help_identical():
    assert _as_jax(params.parity_table()) == jparams.parity_table()
    for scope in (None, "real", "compat"):
        assert _as_jax(params.help_text(scope)) == jparams.help_text(scope)
    assert params.help_text().count("clp_tpu_torch.") == 1
    assert sorted(params.REGISTRY) == sorted(jparams.REGISTRY)


def test_every_param_applies_like_jax(on_cpu):
    """Each registered parameter with a setter takes the same value into the
    same place of the CLI in both packages."""
    samples = {"int": "3", "dbl": "0.5", "bool": "on", "str": "x"}
    for name, p in sorted(params.REGISTRY.items()):
        if p.setter is None:
            continue
        value = p.choices[0] if getattr(p, "choices", None) else samples.get(p.kind, "1")
        ct, cj = CLI(), JaxCLI()
        errs = []
        for cli, mod in ((ct, params), (cj, jparams)):
            try:
                mod.apply(cli, name, value)
                errs.append(None)
            except (TypeError, ValueError) as e:
                errs.append(type(e))
        assert errs[0] == errs[1], name
        for attr in ("log_level", "output_format", "print_mask", "compat_params",
                     "errors_allowed", "directory", "file_defaults"):
            assert getattr(ct, attr) == getattr(cj, attr), (name, attr)
        for attr in vars(cj.options):
            if attr in ("presolve", "devices"):
                continue
            a, b = getattr(ct.options, attr), getattr(cj.options, attr)
            assert (int(a) if hasattr(a, "value") else a) == \
                (int(b) if hasattr(b, "value") else b), (name, attr)
        assert vars(ct.options.presolve) == vars(cj.options.presolve), name


def test_cli_solve_basis_and_solution_in_process(tmp_path, on_cpu, capsys):
    mps = _staircase_mps(tmp_path)
    bas, sol = str(tmp_path / "s.bas"), str(tmp_path / "s.sol")
    cli = CLI()
    assert cli.options.device == "cpu"
    assert cli.run_args([mps, "-dualsimplex", "-basisOut", bas, "-solution", sol]) == 0
    assert cli.model.solution.status == ProblemStatus.OPTIMAL
    cold = cli.model.solution
    jm = jgen.staircase_lp(4, 16, 36, seed=0)
    ref = jm.initial_solve(clp_tpu.SolveOptions(method=clp_tpu.SolveMethod.DUAL_SIMPLEX))
    assert abs(cold.objective_value - ref.objective_value) <= 1e-9 * (1 + abs(ref.objective_value))
    # the solution file reads back to the same primal, to the 8 significant
    # digits it is written with ("%15.8g")
    back = CLI()
    assert back.run_args([mps]) == 0
    assert back.read_solution_file(sol) == 0
    np.testing.assert_allclose(back.model.solution.primal, cold.primal, rtol=5e-8, atol=1e-300)
    # the basis file warm-starts the next solve: no pivot needed
    warm = CLI()
    assert warm.run_args([mps, "-basisIn", bas, "-dualsimplex"]) == 0
    assert warm.model.solution.status == ProblemStatus.OPTIMAL
    assert warm.model.solution.iterations == 0
    assert abs(warm.model.solution.objective_value - cold.objective_value) <= 1e-9 * (
        1 + abs(cold.objective_value))
    out = capsys.readouterr().out
    assert "Optimal - objective value" in out


def test_cli_export_lp_and_reimport(tmp_path, on_cpu):
    mps = _staircase_mps(tmp_path)
    lp = str(tmp_path / "s.lp")
    cli = CLI()
    assert cli.run_args([mps, "-export", lp, "-dualsimplex"]) == 0
    other = CLI()
    assert other.run_args([lp, "-dualsimplex"]) == 0
    a, b = cli.model.solution.objective_value, other.model.solution.objective_value
    assert abs(a - b) <= 1e-9 * (1 + abs(a))


def test_cli_parametrics_file_like_jax(tmp_path, on_cpu):
    A = sp.csc_matrix(np.array([[1.0, 1.0], [1.0, -1.0]]))
    m = clp_tpu.Model()
    m.load_problem(A, [0, 0], [clp_tpu.INF, 3.0], [-1.0, -2.0], [-clp_tpu.INF, -1.0],
                   [1.0, 2.0])
    m.row_names, m.col_names = ["R0", "R1"], ["x", "y"]
    mps = str(tmp_path / "m.mps")
    m.write_mps(mps)
    pf = tmp_path / "p.csv"
    pf.write_text("ROWS,0,4\nname,lower,upper\nR0,0,1\nCOLUMNS\n"
                  "name,lower,upper,objective\ny,0,0,0.5\n")
    outs = []
    for cli in (CLI(), JaxCLI()):
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.run_args([mps, "-parametrics", str(pf)]) == 0
        outs.append([ln for ln in buf.getvalue().splitlines() if ln.startswith("theta")])
    assert outs[0] == outs[1] and len(outs[0]) >= 2


def test_cli_unit_test_and_help(on_cpu, capsys):
    assert main(["-unitTest"]) == 0
    assert "unitTest: OK" in capsys.readouterr().out
    assert main(["-???"]) == 0
    out = capsys.readouterr().out
    assert "clp_tpu_torch" in out and params.help_text() in out
    assert main(["-primalT"]) == 1  # a value-taking parameter with no value


@pytest.mark.parametrize("solve_first", [False, True], ids=["stub", "dualsimplex-stub"])
def test_cli_ampl_stub_like_jax(tmp_path, on_cpu, solve_first):
    """`clp stub -AMPL`: the .nl stub is read, solved (AUTOMATIC, or the
    solve asked for first) and answered in stub.sol, as the JAX CLI does:
    the same header and solve code, values within 1e-9."""
    from clp_tpu.cli import main as jax_main
    from clp_tpu.io.nl import write_nl

    mj = jgen.random_lp(9, 14, seed=4)
    sols = []
    for name, run in (("t", main), ("j", jax_main)):
        stub = str(tmp_path / name)
        write_nl(mj, stub + ".nl")
        argv = [stub, "-dualsimplex", "-AMPL"] if solve_first else [stub, "-AMPL"]
        assert run(argv) == 0
        sols.append(open(stub + ".sol").read().splitlines())
    t, j = sols
    assert len(t) == len(j)
    assert any(ln.startswith("objno 0 0") for ln in t)
    for a, b in zip(t, j):
        try:
            fa, fb = float(a), float(b)
        except ValueError:
            assert a.replace("clp_tpu_torch", "clp_tpu") == b
            continue
        assert abs(fa - fb) <= 1e-9 * (1 + abs(fb))


def test_cli_batch_through_solve_batch(tmp_path, on_cpu, capsys):
    files = []
    for k in range(3):
        m = port_model(jgen.random_lp(8, 12, seed=0))
        m.row_upper = m.row_upper + 0.1 * k
        files.append(str(tmp_path / f"b{k}.mps"))
        m.write_mps(files[-1])
    assert main(["-batch", *files]) == 0
    out = capsys.readouterr().out
    assert out.count("OPTIMAL objective") == 3 and "Batch of 3" in out


def test_module_entry_point_subprocess(tmp_path):
    mps = _staircase_mps(tmp_path)
    r = subprocess.run([sys.executable, "-m", "clp_tpu_torch", mps, "-dualsimplex"],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Optimal - objective value" in r.stdout
    r = subprocess.run([sys.executable, "-m", "clp_tpu_torch", "-unitTest"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "unitTest: OK" in r.stdout, r.stdout + r.stderr[-2000:]
    # the REPL reads commands until quit
    r = subprocess.run([sys.executable, "-m", "clp_tpu_torch"], cwd=tmp_path, env=_env(),
                       input=f"{mps} -dualsimplex\nquit\n", capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "Optimal" in r.stdout, r.stderr[-2000:]


def test_netlib_harness_on_an_empty_directory(tmp_path, on_cpu, capsys):
    assert GOLDEN == __import__("clp_tpu.netlib", fromlist=["GOLDEN"]).GOLDEN
    assert run_netlib(str(tmp_path)) == 0
    assert "no data files found" in capsys.readouterr().out


def test_netlib_harness_on_a_generated_file(tmp_path, on_cpu, capsys):
    """A file named after a Netlib problem is read, solved and held to its
    golden objective (here it is not afiro, so it must fail the check)."""
    port_model(jgen.random_lp(6, 9, seed=1)).write_mps(str(tmp_path / "afiro.mps"))
    assert run_netlib(str(tmp_path), problems=["afiro"]) == 1
    assert "afiro" in capsys.readouterr().out


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("gcc") is None,
                    reason="no compiler")
def test_c_api_client_solves_on_the_cpu(tmp_path):
    lib = native.build_capi()
    exe = str(tmp_path / "test_capi")
    r = subprocess.run(["gcc", str(native.NATIVE_DIR / "test_capi.c"), "-I",
                        str(native.NATIVE_DIR), str(lib), "-lm", "-o", exe],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([exe], cwd=tmp_path, env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    assert "C API test OK" in r.stdout
    assert "status=0 obj=9.000000000 x=[3.000000 1.000000]" in r.stdout

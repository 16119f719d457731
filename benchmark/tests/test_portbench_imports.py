"""What the benchmark imports: never JAX or the JAX package, and in the
reference and the generators nothing of the program either."""

import ast
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent.parent
ROOT = HERE.parent
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "clp_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py"))
                         + sorted((HERE / "generators").glob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_generators_import_nothing_of_the_program(path):
    assert "clp_tpu_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path) - {"__future__"}


def test_a_run_loads_no_jax():
    """The harness, the program's entries and the reference loaded
    together leave no module of JAX or the JAX package in sys.modules."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, program\n"
            "import clp_tpu_torch.parallel.batch, clp_tpu_torch.solve\n"
            "from benchmark.reference import check\n"
            "print(harness.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"

"""Nothing of the benchmark imports jax, jaxlib, flax or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eval_driving_safety_tpu")
PORT = "eval_driving_safety_tpu_torch"
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((PB / "reference").glob("*.py"))


def imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    bad = [m for m in imported(path) if m.split(".")[0] == PORT]
    assert not bad


def test_a_run_loads_no_jax():
    """The harness, a cell's CLI module and the reference loaded together
    leave no forbidden top-level name in sys.modules."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness; "
            "import importlib; c = harness.cell('dsgn_full.pgd_sweep'); "
            "importlib.import_module(c.traffic['module']); "
            "harness.reference_module(c); harness.judge_of(c); "
            "print(harness.forbidden_modules())") % str(PB.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"

"""The port stands alone: no module of eval_driving_safety_tpu_torch, and
not chip_smoke.py, imports jax, flax or the JAX package (an AST scan of
every import statement, including those inside functions)."""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "eval_driving_safety_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "eval_driving_safety_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_port_module_imports_without_a_card():
    """Importing builds nothing and needs no GPU, nvcc or triton."""
    for path in sorted(PORT.rglob("*.py")):
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))

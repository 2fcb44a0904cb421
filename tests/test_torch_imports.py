"""The port stands alone: no file under taper_tpu_torch/ and no line of
chip_smoke.py imports JAX or the JAX package, by an ``import`` statement
or by ``importlib.import_module``/``__import__`` of a literal name.  The
sources are parsed, so comments and strings that name the JAX package's
files (the port's docstrings cite them) do not count."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "taper_tpu")
SOURCES = sorted((ROOT / "taper_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(tree):
    """Every module name the source imports, with its line."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            arg = node.args[0]
            if (name in ("import_module", "__import__")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                yield node.lineno, arg.value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree)
           if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_covers_the_quantization_modules():
    """The PTQ slice's modules are among the sources the guard parses: the
    port keeps its own copy of the JAX package's pure-Python quantization
    modules rather than importing them."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("quantization/__init__.py", "quantization/config.py",
                "quantization/qtensor.py", "quantization/ptq.py",
                "ops/quant.py", "examples/ptq_quantize.py"):
        assert f"taper_tpu_torch/{mod}" in names, mod


def test_the_guard_sees_each_form_of_import():
    src = ("import jax\nfrom taper_tpu.ops import x\n"
           "import importlib\nimportlib.import_module('jax.numpy')\n"
           "__import__('jaxlib')\nimport taper_tpu_torch\n"
           "# import jax\ns = 'taper_tpu/ops/pallas/gemm.py'\n")
    found = [name for _, name in _imports(ast.parse(src))
             if _forbidden(name)]
    assert found == ["jax", "taper_tpu.ops", "jax.numpy", "jaxlib"]

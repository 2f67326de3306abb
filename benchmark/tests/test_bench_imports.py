"""Import guard: nothing the benchmark runs imports JAX or the JAX
package, and the plain reference imports nothing of the system under
test. Names are compared whole, before the first dot: the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "audio_key_estimation_tpu"}
PORT = "audio_key_estimation_torch"


def imported_tops(path: Path) -> set:
    """Top-level names of the absolute modules a source file imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def sources(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


def test_whole_name_comparison():
    assert "audio_key_estimation_torch".split(".")[0] not in NEVER
    assert "audio_key_estimation_tpu.ops".split(".")[0] in NEVER


def test_no_module_of_the_benchmark_imports_jax():
    bad = {str(p.relative_to(BENCH)): sorted(imported_tops(p) & NEVER)
           for p in sources(BENCH)}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_system():
    ref = BENCH / "reference"
    for p in sources(ref):
        assert PORT not in imported_tops(p), p
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                # relative imports stay inside the reference
                assert node.level == 1, (p, node.module)


# every module under reference/, a configuration's own model among them
REFERENCE = ["benchmark.reference" + ("" if p.stem == "__init__"
                                      else f".{p.stem}")
             for p in sources(BENCH / "reference")]


@pytest.mark.parametrize("module", REFERENCE)
def test_loading_the_reference_loads_neither(module):
    code = (f"import sys, {module}; tops = "
            "{m.split('.')[0] for m in sys.modules}; print(sorted(tops & "
            "{'jax', 'jaxlib', 'flax', 'audio_key_estimation_tpu', "
            "'audio_key_estimation_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"

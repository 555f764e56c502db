"""What the benchmark imports, by each module's whole top-level name: no
file of it imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` (``repro_torch`` is another name), and the reference and what it
reads import nothing of ``repro_torch`` either: every architecture's
module (``archs/*.py``, which holds its reference) by its imports and,
loaded in a fresh process, by what that loads."""
import ast
import subprocess
import sys

import pytest

from aisqlbench import spec

JAX = {"jax", "jaxlib", "flax", "repro"}
ARCHS = sorted(p.stem for p in (spec.HERE / "archs").glob("*.py"))
REFERENCE = [f"archs/{a}.py" for a in ARCHS] + [
    "weights.py", "tokens.py", "judge.py", "timeline.py", "traffic.py",
    "devtrace.py", "spec.py"]


def top_names(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(p for p in spec.HERE.rglob("*.py") if "_cache" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not top_names(path) & JAX


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_reads_nothing_of_the_program(name):
    assert "repro_torch" not in top_names(spec.HERE / name)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; from aisqlbench import judge, spec; "
            f"[spec.load_arch(a) for a in {ARCHS!r}]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_harness_sees_a_jax_module():
    from aisqlbench import harness
    assert "repro" in harness.FORBIDDEN and "repro_torch" not in \
        harness.FORBIDDEN
    sys.modules.setdefault("repro_torch_fake_for_test", None)
    try:
        assert "repro_torch_fake_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_fake_for_test"]

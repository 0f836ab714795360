"""The no-import check, and the yardstick's independence from the
program."""

import ast
import subprocess
import sys

import pytest

from mmbench import harness

YARDSTICK = ("reference.py", "check.py", "counts.py", "traffic.py",
             "stand_in.py")


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib",
                                  "jaxlib.xla_client", "flax", "flax.linen",
                                  "modelmesh_tpu", "modelmesh_tpu.ops.solve"])
def test_refused(name):
    assert harness.forbidden_modules([name]) == [name]


@pytest.mark.parametrize("name", ["modelmesh_tpu_torch",
                                  "modelmesh_tpu_torch.ops.solve", "jaxtyping",
                                  "modelmesh_tpux", "mmbench.harness",
                                  "torch"])
def test_allowed(name):
    assert harness.forbidden_modules([name]) == []


def imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    names = imported(harness.PKG / name)
    assert "modelmesh_tpu_torch" not in names
    assert not harness.forbidden_modules(names)


def test_reference_loads_no_program_module():
    code = ("import sys; import mmbench.reference, mmbench.check, "
            "mmbench.counts, mmbench.stand_in, mmbench.traffic; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('modelmesh_tpu_torch', 'modelmesh_tpu', "
            "'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_file_of_the_benchmark_imports_jax():
    for path in harness.PKG.rglob("*.py"):
        assert not harness.forbidden_modules(imported(path)), path

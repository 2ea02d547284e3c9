"""Nothing under portbench imports JAX or the JAX package, and the plain
reference imports nothing of the program either (top-level module names
compared whole: ``boltzfft_torch`` begins with ``boltzfft``)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import cells, harness

PKG = Path(harness.__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "boltzfft"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "dataclasses", "math", "pathlib", "numpy",
                                       "torch"}


def test_names_are_compared_whole(monkeypatch):
    import boltzfft_torch  # noqa: F401  (the port: begins with the JAX package's name)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "boltzfft.operator", object())
    assert harness.forbidden_modules() == ["boltzfft", "jax"]


def test_a_run_holds_no_jax_module():
    """The harness and the program together load no JAX module."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import harness, solvers, check, devtrace, control;"
            "import boltzfft_torch, boltzfft_torch.cli.taylor_green_2d3v;"
            "print(harness.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

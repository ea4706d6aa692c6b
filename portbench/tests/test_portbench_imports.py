"""Nothing under portbench/ imports jax, jaxlib, flax, optax or the JAX
package monolith_tpu (top-level names compared whole: monolith_tpu_torch
is the program), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "monolith_tpu"}


def _sources():
    for d, _, names in os.walk(HERE):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for n in os.listdir(ref):
        if n.endswith(".py"):
            names = set(_top_level_imports(os.path.join(ref, n)))
            assert names <= {"__future__", "contextlib", "math", "typing",
                             "numpy", "torch", "portbench"}, (n, names)
            with open(os.path.join(ref, n)) as f:
                src = f.read()
            for mod in ("portbench.models", "portbench.drivers",
                        "portbench.run", "monolith"):
                assert mod not in src.replace("portbench.reference", ""), n


def test_a_run_loads_no_jax():
    code = ("from portbench.tests import small; from portbench import run; "
            "small.execute(); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

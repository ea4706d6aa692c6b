"""The port imports nothing of JAX and nothing of the JAX package: every
module of monolith_tpu_torch, and chip_smoke.py, is checked with ast."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "monolith_tpu"}


def _port_files():
    out = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "monolith_tpu_torch")):
        out += [os.path.relpath(os.path.join(dirpath, f), ROOT)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py"]


def _imported_roots(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files())
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_walk_covers_the_slice():
    files = set(_port_files())
    for must in ("monolith_tpu_torch/ops/scatter.py",
                 "monolith_tpu_torch/training/trainer.py",
                 "monolith_tpu_torch/embedding/engine.py"):
        assert must in files

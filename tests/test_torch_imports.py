"""The port imports nothing of JAX (nor ml_dtypes or msgpack) and nothing
of the JAX package, and `grpc` only in the modules that serve RPCs: every
module of monolith_tpu_torch, and chip_smoke.py, is checked with ast."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "msgpack",
             "grpc", "monolith_tpu"}
#: the modules that serve or call RPCs, the only ones that may import grpc
GRPC_MODULES = ("monolith_tpu_torch/serving/agent.py",
                "monolith_tpu_torch/serving/param_sync.py",
                "monolith_tpu_torch/training/controller.py")


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
    forbidden = FORBIDDEN - {"grpc"} if path in GRPC_MODULES else FORBIDDEN
    bad = sorted(set(_imported_roots(path)) & forbidden)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", GRPC_MODULES)
def test_grpc_modules_are_the_rpc_ones(path):
    assert "grpc" in set(_imported_roots(path)), path


def test_serving_model_imports_no_grpc():
    """`ServingModel` and the package's other eager names load without
    grpc; the RPC names load it at first use."""
    code = ("import sys; import monolith_tpu_torch.serving as s; "
            "s.ServingModel, s.FileDiscovery, s.export_model; "
            "assert 'grpc' not in sys.modules; s.SyncClientManager; "
            "assert 'grpc' in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_walk_covers_the_slice():
    files = set(_port_files())
    for must in ("monolith_tpu_torch/ops/scatter.py",
                 "monolith_tpu_torch/ops/rounding.py",
                 "monolith_tpu_torch/training/trainer.py",
                 "monolith_tpu_torch/embedding/engine.py",
                 "monolith_tpu_torch/embedding/merge.py",
                 "monolith_tpu_torch/embedding/tiered.py",
                 "monolith_tpu_torch/models/multislot.py",
                 "monolith_tpu_torch/ops/clip.py",
                 "monolith_tpu_torch/embedding/optimizers.py",
                 "monolith_tpu_torch/profile_step.py",
                 "monolith_tpu_torch/serialization.py",
                 "monolith_tpu_torch/training/checkpoint.py",
                 "monolith_tpu_torch/training/streaming.py",
                 "monolith_tpu_torch/serving/__init__.py",
                 "monolith_tpu_torch/serving/engine.py",
                 "monolith_tpu_torch/serving/export.py",
                 "monolith_tpu_torch/serving/codec.py",
                 "monolith_tpu_torch/data/framing.py",
                 "monolith_tpu_torch/embedding/compressors.py",
                 "monolith_tpu_torch/embedding/retrievers.py",
                 "monolith_tpu_torch/data/example.py",
                 "monolith_tpu_torch/data/pb_compat.py",
                 "monolith_tpu_torch/data/datasets.py",
                 "monolith_tpu_torch/data/prefetch.py",
                 "monolith_tpu_torch/data/movielens.py",
                 "monolith_tpu_torch/config.py",
                 "monolith_tpu_torch/utils/__init__.py",
                 "monolith_tpu_torch/utils/metrics_client.py",
                 "monolith_tpu_torch/utils/deep_insight.py",
                 "monolith_tpu_torch/training/hooks.py",
                 "monolith_tpu_torch/training/recovery.py",
                 "monolith_tpu_torch/models/movie_ranking.py",
                 "monolith_tpu_torch/estimator.py",
                 "monolith_tpu_torch/train.py",
                 "monolith_tpu_torch/demo.py",
                 "monolith_tpu_torch/parity.py",
                 "monolith_tpu_torch/serving/discovery.py",
                 "monolith_tpu_torch/serving/param_sync.py",
                 "monolith_tpu_torch/serving/agent.py",
                 "monolith_tpu_torch/serving/router.py",
                 "monolith_tpu_torch/training/controller.py",
                 "monolith_tpu_torch/data/__init__.py",
                 "monolith_tpu_torch/data/transforms.py",
                 "monolith_tpu_torch/data/item_pool.py",
                 "monolith_tpu_torch/data/feature_list.py",
                 "monolith_tpu_torch/utils/tuning.py",
                 "monolith_tpu_torch/utils/alerts.py",
                 "monolith_tpu_torch/layers/__init__.py",
                 "monolith_tpu_torch/layers/initializers.py",
                 "monolith_tpu_torch/layers/activations.py",
                 "monolith_tpu_torch/layers/agru.py",
                 "monolith_tpu_torch/layers/cross.py",
                 "monolith_tpu_torch/layers/feature_cross.py",
                 "monolith_tpu_torch/layers/feature_trans.py",
                 "monolith_tpu_torch/layers/multi_task.py",
                 "monolith_tpu_torch/models/__init__.py",
                 "monolith_tpu_torch/models/ffm.py",
                 "monolith_tpu_torch/models/din.py",
                 "monolith_tpu_torch/models/multitask.py",
                 "monolith_tpu_torch/models/dcn.py",
                 "monolith_tpu_torch/models/autoint.py",
                 "monolith_tpu_torch/layers/norms.py",
                 "monolith_tpu_torch/layers/draws.py",
                 "monolith_tpu_torch/layers/dense.py",
                 "monolith_tpu_torch/layers/lhuc.py",
                 "monolith_tpu_torch/layers/logit_correction.py",
                 "monolith_tpu_torch/layers/pooling.py",
                 "monolith_tpu_torch/optimizers/__init__.py",
                 "monolith_tpu_torch/optimizers/dense.py",
                 "monolith_tpu_torch/losses/__init__.py",
                 "monolith_tpu_torch/losses/losses.py",
                 "monolith_tpu_torch/losses/ltr.py",
                 "monolith_tpu_torch/ops/__init__.py",
                 "monolith_tpu_torch/ops/insight.py",
                 "monolith_tpu_torch/ops/seq.py",
                 "monolith_tpu_torch/feature.py",
                 "monolith_tpu_torch/model_dump.py",
                 "monolith_tpu_torch/compat.py",
                 "monolith_tpu_torch/parallel/__init__.py",
                 "monolith_tpu_torch/parallel/mesh.py",
                 "monolith_tpu_torch/parallel/sharded.py",
                 "monolith_tpu_torch/parallel/multihost.py"):
        assert must in files


def test_sharded_rank_worker_imports_no_jax():
    """The rank processes of the sharded tests run the port alone."""
    path = "tests/torch_sharded_worker.py"
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_multihost_rank_worker_imports_no_jax():
    """The rank processes of the multi-host tests run the port alone."""
    path = "tests/torch_multihost_worker.py"
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_soa_rank_worker_imports_no_jax():
    """The rank processes of the structure-of-arrays sharded tests run the
    port alone."""
    path = "tests/torch_soa_worker.py"
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"

"""The port's dense optimizers (optimizers/dense.py: optax.adagrad's form,
adamom, adamom_v2, rmsprop_v2, shampoo) against the JAX package's, on the
CPU.

- Updates: 20 steps on the same parameters and gradients, made from a seed
  with numpy (a Dense kernel, which the port holds transposed, a bias and
  a 3-D tensor), in both packages: parameters and the optimizer's state
  tree (`state_tree`, against flax's `to_state_dict` of the optax state) to
  rtol 1e-5 (Shampoo, whose two `eigh` differ, 1e-4). Shampoo's kernel is
  square, so that its statistics L = G G^T and R = G^T G have full rank
  from the first step: a rank-deficient statistic has eigenvalues at the
  epsilon floor, whose rounding (no two `eigh` share it) sets their
  inverse fourth roots. The port's tree
  round-trips through msgpack into flax's template, and flax's bytes load
  into the port's state.
- Convergence: tests/test_infra.py's checks, on the port.
- Checkpoints: a trainer with the BatchNorm module of chip_smoke.py's phase
  15 (`library_task`, dropout off) and each optimizer: a JAX checkpoint
  restores into the port and a port checkpoint into the JAX trainer; the
  optimizer's whole tree and `model_state` cross exactly, and the next
  steps of both agree (rtol 1e-5 / atol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser

import chip_smoke
from monolith_tpu import optimizers as jopt
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch import optimizers as popt
from monolith_tpu_torch import serialization as pser
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

#: name -> (JAX transform, port optimizer, rtol of the 20 updates, the
#: Dense kernel's shape [in, out])
OPTIMIZERS = {
    "adagrad": (lambda: optax.adagrad(0.01), lambda: popt.Adagrad(0.01),
                1e-5, (5, 3)),
    "adamom": (lambda: jopt.adamom(learning_rate=0.02, weight_decay=0.01),
               lambda: popt.adamom(learning_rate=0.02, weight_decay=0.01),
               1e-5, (5, 3)),
    "adamom_v2": (lambda: jopt.adamom_v2(learning_rate=0.02),
                  lambda: popt.adamom_v2(learning_rate=0.02), 1e-5, (5, 3)),
    "rmsprop_v2": (lambda: jopt.rmsprop_v2(learning_rate=0.05,
                                           weight_decay=0.01),
                   lambda: popt.rmsprop_v2(learning_rate=0.05,
                                           weight_decay=0.01), 1e-5,
                   (5, 3)),
    "shampoo": (lambda: jopt.shampoo(learning_rate=0.1,
                                     update_preconditioner_every=4),
                lambda: popt.shampoo(learning_rate=0.1,
                                     update_preconditioner_every=4), 1e-4,
                (4, 4)),
    "shampoo_defaults": (jopt.shampoo, popt.shampoo, 1e-4, (4, 4)),
}


def _params(kernel, seed=0):
    """flax-form parameters: a Dense kernel [in, out], its bias, a 3-D
    leaf."""
    rng = np.random.default_rng(seed)
    return {"layer": {"kernel": rng.normal(size=kernel).astype(np.float32),
                      "bias": rng.normal(size=kernel[1:]).astype(np.float32)},
            "cube": rng.normal(size=(2, 3, 4)).astype(np.float32)}


def _grads(params, steps, seed=1):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), params) for _ in range(steps)]


def _port_named(tree):
    return {k: torch.from_numpy(np.array(v))
            for k, v in convert._to_module_tensors(tree).items()}


def _assert_trees_close(got, want, rtol, atol=ATOL):
    g, w = convert._flatten(got), convert._flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=str(k))


@pytest.fixture(scope="module", params=sorted(OPTIMIZERS))
def updated(request):
    """20 updates in both packages: (name, JAX params, JAX state, port
    parameters, port optimizer, port state, rtol)."""
    make_j, make_p, rtol, kernel = OPTIMIZERS[request.param]
    p0 = _params(kernel)
    grads = _grads(p0, 20)
    tx = make_j()
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    for g in grads:
        u, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
    ptx = make_p()
    pp = _port_named(p0)
    ps = ptx.init(pp.items())
    for g in grads:
        ptx.update_(list(pp.items()), _port_named(g), ps)
    return request.param, jp, js, pp, ptx, ps, rtol


def test_twenty_updates_match_jax(updated):
    _, jp, _, pp, _, _, rtol = updated
    _assert_trees_close(convert.dense_tree(pp), jax.device_get(jp), rtol)


def test_state_tree_is_flax_form(updated):
    _, _, js, _, ptx, ps, rtol = updated
    _assert_trees_close(ptx.state_tree(ps),
                        fser.to_state_dict(jax.device_get(js)), rtol)


def test_state_tree_crosses_msgpack_both_ways(updated):
    """The port's bytes restore into flax's template of the optax state;
    flax's bytes load into the port's state, which then writes them
    again byte for byte."""
    _, _, js, _, ptx, ps, rtol = updated
    jbytes = fser.to_bytes(jax.device_get(js))
    restored = fser.from_bytes(js, pser.to_bytes(ptx.state_tree(ps)))
    _assert_trees_close(fser.to_state_dict(restored),
                        fser.to_state_dict(jax.device_get(js)), rtol)
    ptx.load_state_tree(ps, pser.from_bytes(ptx.state_tree(ps), jbytes))
    assert pser.to_bytes(ptx.state_tree(ps)) == jbytes


def _fit(tx, w0, steps):
    params = {"w": torch.tensor(w0)}
    state = tx.init(params.items())
    for _ in range(steps):
        tx.update_(list(params.items()), {"w": 2.0 * params["w"]}, state)
    return float(torch.sum(params["w"] ** 2))


@pytest.mark.parametrize("name, tx, w0, steps, bound", [
    ("adamom", popt.adamom(learning_rate=0.02), [5.0, -3.0], 800, 0.3),
    ("adamom_v2", popt.adamom_v2(learning_rate=0.02), [5.0, -3.0], 800, 0.3),
    ("rmsprop_v2", popt.rmsprop_v2(learning_rate=0.1), [5.0, -3.0], 200,
     0.1),
    ("shampoo_matrix", popt.shampoo(learning_rate=0.3,
                                    update_preconditioner_every=5),
     np.full((4, 3), 2.0, np.float32).tolist(), 150, 0.1),
])
def test_converges_as_the_jax_tests_ask(name, tx, w0, steps, bound):
    """tests/test_infra.py's TestDenseOptimizers on the port: sum(w^2)
    after `steps` updates below the bound."""
    assert _fit(tx, w0, steps) < bound, name


def test_shampoo_preconditions_the_flax_kernel():
    """A Dense weight [out, in] is preconditioned as the flax kernel
    [in, out]: L is [in, in], R [out, out], in the state and its tree."""
    ptx = popt.shampoo()
    p = {"d.weight": torch.zeros(3, 5), "d.bias": torch.zeros(3)}
    st = ptx.init(p.items())
    assert st["l_stat"]["d.weight"].shape == (5, 5)
    assert st["r_root"]["d.weight"].shape == (3, 3)
    assert st["l_stat"]["d.bias"].shape == ()
    tree = ptx.state_tree(st)
    assert tree["l_root"]["d"]["kernel"].shape == (5, 5)
    assert tree["diag"]["d"]["kernel"].shape == (5, 3)
    assert tree["count"].dtype == np.int32 and tree["count"].shape == ()


# ----------------------------------------------------------------------
# checkpoints of a BatchNorm trainer with each optimizer, both ways
# ----------------------------------------------------------------------

U, B = 512, 64
#: init_scale 0: a new id's row starts at zero in both packages (their
#: init draws come from different generators)
TASK = dict(embedding_dim=8, capacity_per_shard=4096, init_scale=0.0)
JAX_TX = {"adagrad": lambda: optax.adagrad(0.01), "adamom": jopt.adamom,
          "adamom_v2": jopt.adamom_v2, "rmsprop_v2": jopt.rmsprop_v2,
          "shampoo": jopt.shampoo}


def jax_library_task(optimizer, keep_prob=1.0):
    from test_torch_library import JaxLibraryModule

    @dataclasses.dataclass
    class JaxLibraryTask(JaxDeepFMTask):
        def build_module(self):
            return JaxLibraryModule(keep_prob=keep_prob)

        def dense_optimizer(self):
            return JAX_TX[optimizer]()

    return JaxLibraryTask(**TASK)


def jax_trainer(optimizer):
    return JaxTrainer(jax_library_task(optimizer), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=U, new_cap=U),
        log_every=0))


def port_trainer(optimizer):
    return Trainer(chip_smoke.library_task(optimizer, keep_prob=1.0, **TASK),
                   TrainerConfig(engine=EngineConfig(unique_cap=U, new_cap=U),
                                 log_every=0), device="cpu")


def _pairs(n, seed):
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=B, seed=seed)
    return [data.batch() for _ in range(n)]


def _assert_dense_equal(got, want):
    for tree in ("params", "opt_state", "model_state"):
        x, y = convert._flatten(got[tree]), convert._flatten(want[tree])
        assert sorted(x) == sorted(y), tree
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=str(k))


@pytest.mark.parametrize("optimizer", chip_smoke.LIB_OPTIMIZERS)
def test_checkpoints_with_each_optimizer_cross_both_ways(optimizer,
                                                         tmp_path):
    pairs = _pairs(4, seed=40)
    jt = jax_trainer(optimizer)
    for i, p in enumerate(pairs[:3]):
        jt.train_step(*p, ts=100 + i)
    assert jt.model_state and "batch_stats" in jt.model_state
    jckpt.save(jt, str(tmp_path / "jax"))
    pt = port_trainer(optimizer)
    assert pckpt.restore(pt, str(tmp_path / "jax")) == 3
    _assert_dense_equal(convert.export_state(pt),
                        convert.jax_trainer_state(jt))
    # the next step of both, from the restored state
    jo = jt.train_step(*pairs[3], ts=103)
    po = pt.train_step(*pairs[3], ts=103)
    np.testing.assert_allclose(po["loss"].item(), float(jo["loss"]),
                               rtol=RTOL)
    # and back: the port's checkpoint into the JAX trainer
    pckpt.save(pt, str(tmp_path / "port"))
    assert jckpt.restore(jt, str(tmp_path / "port")) == 4
    _assert_dense_equal(convert.jax_trainer_state(jt),
                        convert.export_state(pt))
    fb, b = _pairs(1, seed=41)[0]
    jo = jt.train_step(fb, b, ts=104)
    po = pt.train_step(fb, b, ts=104)
    np.testing.assert_allclose(po["loss"].item(), float(jo["loss"]),
                               rtol=RTOL, atol=ATOL)
    got = convert._flatten(pt.model_state)
    for k, v in convert._flatten(jax.device_get(jt.model_state)).items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=str(k))

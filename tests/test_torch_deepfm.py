"""The port's DeepFM dense side against the JAX package's, from carried
flax params: the module forward, bce_with_logits, the FM interaction, the
combiners and the optax-form dense Adagrad. f32 on the CPU; rtol 1e-5 for
the tower (matrix products sum in another order), 1e-6 for elementwise
math."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monolith_tpu.feature import combine as jcombine
from monolith_tpu.losses import bce_with_logits as jbce
from monolith_tpu.models.deepfm import DeepFMModule as JaxDeepFMModule
from monolith_tpu.ops.interactions import fm_interaction as jfm
from monolith_tpu_torch import convert
from monolith_tpu_torch.feature import combine
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.losses.losses import bce_with_logits
from monolith_tpu_torch.models.deepfm import DeepFMModule
from monolith_tpu_torch.ops.interactions import fm_interaction
from monolith_tpu_torch.optimizers.dense import Adagrad

torch.set_num_threads(1)

FEATS = ("user_id", "item_id", "hist_items")


def _pooled(seed, B, D):
    rng = np.random.default_rng(seed)
    return {f: rng.normal(size=(B, D + 1)).astype(np.float32) for f in FEATS}


def _carried(seed, D, hidden):
    """flax DeepFM params from a JAX init, and a port module holding them."""
    jmod = JaxDeepFMModule(embedding_dim=D, hidden=hidden)
    pooled = {k: jnp.asarray(v) for k, v in _pooled(0, 4, D).items()}
    params = jmod.init(jax.random.PRNGKey(seed), pooled, {},
                       training=True)["params"]
    pmod = DeepFMModule(embedding_dim=D, hidden=hidden)
    named = convert._to_module_tensors(params)
    pmod.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in named.items()})
    return jmod, params, pmod


@pytest.mark.parametrize("seed,B,D,hidden", [(0, 8, 4, (16, 8)),
                                             (1, 64, 16, (32, 16)),
                                             (2, 33, 16, (256, 128, 64))])
def test_deepfm_forward_and_loss_match_jax(seed, B, D, hidden):
    jmod, params, pmod = _carried(seed, D, hidden)
    pooled = _pooled(seed + 10, B, D)
    labels = (np.random.default_rng(seed).random(B) < 0.4).astype(np.float32)
    ref = np.array(jmod.apply({"params": params},
                                {k: jnp.asarray(v) for k, v in pooled.items()},
                                {}, training=True)["logits"])
    out = pmod({k: torch.from_numpy(v) for k, v in pooled.items()})["logits"]
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    ref_loss = float(jbce(jnp.asarray(ref), jnp.asarray(labels)))
    loss = float(bce_with_logits(torch.from_numpy(ref), torch.from_numpy(labels)))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_fm_interaction_matches_jax(seed):
    x = np.random.default_rng(seed).normal(size=(16, 3, 8)).astype(np.float32)
    np.testing.assert_allclose(fm_interaction(torch.from_numpy(x)).numpy(),
                               np.asarray(jfm(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("combiner", ["sum", "mean", "firstn"])
def test_combine_matches_jax(combiner):
    rng = np.random.default_rng(3)
    valid = rng.random((12, 5)) < 0.6
    valid[0] = False  # an example with no ids: mean divides by max(0, 1)
    emb = rng.normal(size=(12, 5, 4)).astype(np.float32) * valid[..., None]
    out = combine(torch.from_numpy(emb), torch.from_numpy(valid), combiner)
    ref = jcombine(jnp.asarray(emb), jnp.asarray(valid), combiner)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_mlp_init_is_glorot_uniform_with_zero_bias():
    mlp = MLP(48, (256, 1), generator=torch.Generator().manual_seed(0))
    w = mlp.dense_0.weight.detach().numpy()
    limit = np.sqrt(6.0 / (48 + 256))
    assert w.shape == (256, 48)
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.9 * limit
    np.testing.assert_array_equal(mlp.dense_0.bias.detach().numpy(), 0.0)


@pytest.mark.parametrize("steps", [1, 4])
def test_dense_adagrad_matches_optax(steps):
    rng = np.random.default_rng(steps)
    p0 = {"w": rng.normal(size=(6, 5)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(steps)]
    grads[0]["b"][0] = 0.0  # a zero gradient keeps acc > 0 (init 0.1)
    tx = optax.adagrad(learning_rate=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    for g in grads:
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
    ptx = Adagrad(learning_rate=0.01)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ps = ptx.init(pp.items())
    for g in grads:
        ptx.update_(pp.items(), {k: torch.from_numpy(v) for k, v in g.items()},
                    ps)
    for k in p0:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ps[k].numpy(),
                                   np.asarray(js[0].sum_of_squares[k]),
                                   rtol=1e-6)

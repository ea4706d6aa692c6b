"""The rest of the port's model library against the JAX package's, on the
CPU: layers/{norms,dense,lhuc,logit_correction,pooling}.py, SNR and DCN's
dropout, losses/{losses,ltr}.py, ops/{insight,seq}.py, model_dump.py,
compat.py, and the trainer's training flag, `model_state` and drawing
layers.

Layers: the same inputs, made from a seed with numpy, go through the flax
layer and the port's, whose parameters (and BatchNorm statistics) are the
flax `init`'s carried by convert.py; outputs and the input gradients of a
random projection of them to rtol 1e-5 / atol 1e-6. Losses and ops: values
and the gradients with respect to their inputs, to the same tolerance.
Draws (DCN's dropout, SNR's gate) are held by distribution: the two
packages' random streams differ.

Trainers: phase 15's module of chip_smoke.py (`library_task`; its flax
twin `JaxLibraryModule` below) with dropout off trains 3 carried steps
equal to the JAX trainer (losses, parameters, batch_stats). With dropout
on, the JAX trainer cannot train it (fault R3 of the reference: it passes
no rngs) and the port does; a block of 4 equals 4 steps bit for bit, and a
restored trainer's next step equals the original's.
"""

import dataclasses
import json

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from monolith_tpu import compat as jcompat
from monolith_tpu import layers as jl
from monolith_tpu import losses as jlosses
from monolith_tpu import ops as jops
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.model_dump import dump_model as jax_dump_model
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training.task import RecTask as JaxRecTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import compat as pcompat
from monolith_tpu_torch import convert
from monolith_tpu_torch import layers as pl
from monolith_tpu_torch import losses as plosses
from monolith_tpu_torch import model_dump as pdump
from monolith_tpu_torch import ops as pops
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.layers import initializers as pinit
from monolith_tpu_torch.layers.draws import set_generator
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.task import RecTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
KEY = jax.random.PRNGKey(0)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=RTOL,
        atol=ATOL, err_msg=msg)


def _load(module, variables):
    """flax variables ({"params", optionally "batch_stats"}) into the port
    module by convert.py; they read back out as the flax trees."""
    convert.load_dense_tree(dict(module.named_parameters()),
                            variables["params"])
    if "batch_stats" in variables:
        convert.load_model_state(module,
                                 {"batch_stats": variables["batch_stats"]})
    for path, arr in convert._flatten(variables["params"]).items():
        np.testing.assert_array_equal(convert._flatten(convert.dense_tree(
            module.named_parameters()))[path], arr)
    return module


def _check(jfn, pfn, inputs, diff):
    """Outputs of jfn(*inputs) and pfn(*torch inputs), and the gradients of
    sum(out * r) (r random, per output) with respect to inputs[diff]."""
    jout = jfn(*inputs)
    tin = [_t(x).requires_grad_(i in diff) for i, x in enumerate(inputs)]
    pout = pfn(*tin)
    jouts = jout if isinstance(jout, (list, tuple)) else [jout]
    pouts = pout if isinstance(pout, (list, tuple)) else [pout]
    assert len(jouts) == len(pouts)
    for j, p in zip(jouts, pouts):
        _close(p, j)
    if not diff:
        return
    rs = [_normal(99 + k, *np.shape(j)) for k, j in enumerate(jouts)]

    def proj(*xs):
        o = jfn(*[xs[diff.index(i)] if i in diff else x
                  for i, x in enumerate(inputs)])
        o = o if isinstance(o, (list, tuple)) else [o]
        return sum(jnp.sum(a * r) for a, r in zip(o, rs))

    jg = jax.grad(proj, argnums=tuple(range(len(diff))))(
        *[inputs[i] for i in diff])
    total = sum(torch.sum(p * _t(r)) for p, r in zip(pouts, rs))
    pg = torch.autograd.grad(total, [tin[i] for i in diff])
    for a, b in zip(pg, jg):
        _close(a, b, "input gradient")


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 6), (4, 5, 6)])
def test_batchnorm_trains_as_flax(shape):
    """Batch statistics over every axis but the last (biased variance, E[x^2]
    - E[x]^2), running averages moved by momentum 0.99; output and input
    gradient."""
    x = _normal(1, *shape) * 3.0 + 1.0
    jm = nn.BatchNorm(use_running_average=False)
    v = jm.init(KEY, x)
    v = {"params": {"scale": _normal(2, 6), "bias": _normal(3, 6)},
         "batch_stats": {"mean": _normal(4, 6), "var": np.abs(_normal(5, 6))}}
    pm = _load(pl.BatchNorm(6), v).train()

    def jfn(x):
        return jm.apply(v, x, mutable=["batch_stats"])[0]
    _check(jfn, pm, [x], diff=[0])
    _, new = jm.apply(v, x, mutable=["batch_stats"])
    pm2 = _load(pl.BatchNorm(6), v).train()
    pm2(_t(x))
    for k in ("mean", "var"):
        _close(getattr(pm2, k), new["batch_stats"][k], k)


def test_batchnorm_uses_running_averages_in_eval_and_when_asked():
    x = _normal(6, 8, 6)
    v = {"params": {"scale": _normal(2, 6), "bias": _normal(3, 6)},
         "batch_stats": {"mean": _normal(4, 6), "var": np.abs(_normal(5, 6))}}
    jm = nn.BatchNorm(use_running_average=True)
    pm = _load(pl.BatchNorm(6), v).eval()
    _check(lambda x: jm.apply(v, x), pm, [x], diff=[0])
    fixed = _load(pl.BatchNorm(6, use_running_average=True), v).train()
    _check(lambda x: jm.apply(v, x), fixed, [x], diff=[0])
    before = fixed.mean.clone()
    fixed(_t(x))
    assert torch.equal(fixed.mean, before)   # no update on running averages


@pytest.mark.parametrize("shape", [(4, 6), (3, 4, 6)])
def test_layernorm_matches_flax(shape):
    x = _normal(7, *shape) * 2.0 + 0.5
    jm = nn.LayerNorm()
    v = {"params": {"scale": _normal(8, 6), "bias": _normal(9, 6)}}
    pm = _load(pl.LayerNorm(6), v)
    assert pm.epsilon == jm.epsilon == 1e-6
    _check(lambda x: jm.apply(v, x), pm, [x], diff=[0])


@pytest.mark.parametrize("relative_diff", [False, True])
def test_gradnorm_and_second_order_grad_norms(relative_diff):
    """GradNorm's two losses, and the gradient of its balancing loss with
    respect to a shared layer's weights through grad_norms_wrt, which is
    second order in both packages."""
    x, w0, heads = _normal(10, 8, 5), _normal(11, 5, 4), _normal(12, 3, 4)
    gw = _normal(13, 3) * 0.3
    jm = jl.GradNorm(num_tasks=3, relative_diff=relative_diff)
    v = {"params": {"grad_norm_weights": gw}}
    pm = pl.GradNorm(3, relative_diff=relative_diff)
    _load(pm, v)

    def jtask_losses(shared, heads):
        return jnp.stack([jnp.mean((shared @ heads[t]) ** 2)
                          for t in range(3)])

    def jobjective(w):
        losses, gn = jl.grad_norms_wrt(jnp.tanh(x @ w), jtask_losses, heads)
        return jm.apply(v, losses, gn)

    def ptask_losses(shared, heads):
        return torch.stack([torch.mean((shared @ heads[t]) ** 2)
                            for t in range(3)])

    w = _t(w0).requires_grad_()
    losses, gn = pl.grad_norms_wrt(torch.tanh(_t(x) @ w), ptask_losses,
                                   _t(heads))
    wl, gl = pm(losses, gn)
    jwl, jgl = jobjective(w0)
    _close(wl, jwl, "weighted loss")
    _close(gl, jgl, "gnorm loss")
    (g,) = torch.autograd.grad(gl, w)
    _close(g, jax.grad(lambda w: jobjective(w)[1])(w0), "second order")


# ----------------------------------------------------------------------
# dense, lhuc, logit correction, pooling
# ----------------------------------------------------------------------

DENSE_CASES = {
    "plain": dict(),
    "kernel_norm": dict(allow_kernel_norm=True),
    "kernel_norm_fixed": dict(allow_kernel_norm=True,
                              kernel_norm_trainable=False),
    "no_bias": dict(use_bias=False),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_matches_flax(case):
    kw = DENSE_CASES[case]
    x = _normal(14, 4, 6)
    jm = jl.Dense(5, **kw)
    v = jm.init(KEY, x)
    v = jax.tree.map(lambda a: np.asarray(a) + _normal(15, *a.shape) * 0.1,
                     flax.core.unfreeze(v))
    pm = _load(pl.Dense(6, 5, **kw), v)
    _check(lambda x: jm.apply(v, x), pm, [x], diff=[0])


def test_dense_init_is_glorot_uniform_and_addbias():
    pm = pl.Dense(300, 200, allow_kernel_norm=True,
                  generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / 500)
    w = pm.weight.detach().numpy()
    assert w.shape == (200, 300) and np.abs(w).max() <= limit
    np.testing.assert_allclose(w.std(), limit / np.sqrt(3), rtol=0.02)
    assert torch.equal(pm.kernel_norm, torch.ones(200))
    x = _normal(16, 3, 4)
    v = {"params": {"bias": _normal(17, 4)}}
    _check(lambda x: jl.AddBias().apply(v, x), _load(pl.AddBias(4), v), [x],
           diff=[0])


@pytest.mark.parametrize("gated", [False, True])
def test_lhuc_tower_matches_flax(gated):
    x, g = _normal(18, 4, 6), _normal(19, 4, 5)
    jm = jl.LHUCTower((8, 4), lhuc_hidden=(3,))
    inputs = [x, g] if gated else [x]
    v = jm.init(KEY, *inputs)
    pm = _load(pl.LHUCTower(6, (8, 4), lhuc_dim=5 if gated else None,
                            lhuc_hidden=(3,)), v)
    _check(lambda *a: jm.apply(v, *a), pm, inputs,
           diff=[0, 1] if gated else [0])


@pytest.mark.parametrize("sample_bias", [False, True])
@pytest.mark.parametrize("with_rate", [False, True])
def test_logit_correction_matches_jax(sample_bias, with_rate):
    logits = _normal(20, 16)
    rate = np.abs(_normal(21, 16)) + (0.0 if with_rate else 1.0)
    rate[0] = 0.0  # clamped at 1e-20
    inputs = [logits, rate] if with_rate else [logits]
    _check(lambda *a: jl.logit_correction(*a, sample_bias=sample_bias),
           lambda *a: pl.LogitCorrection(sample_bias)(*a), inputs, diff=[0])


@pytest.mark.parametrize("kind", ["sum", "avg", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_pooling_matches_jax(kind, masked):
    x = _normal(22, 4, 5, 3)
    mask = (np.random.default_rng(23).random((4, 5)) > 0.4).astype(
        np.float32)
    mask[1] = 0.0   # a row with no valid position
    inputs = [x, mask] if masked else [x]
    _check(getattr(jl, f"{kind}_pooling"), getattr(pl, f"{kind}_pooling"),
           inputs, diff=[0])
    cls = {"sum": "SumPooling", "avg": "AvgPooling", "max": "MaxPooling"}
    _close(getattr(pl, cls[kind])()(*[_t(a) for a in inputs]),
           getattr(jl, cls[kind])()(*inputs))


# ----------------------------------------------------------------------
# drawing layers: SNR, DCN's dropout
# ----------------------------------------------------------------------

@pytest.mark.parametrize("snr_type", ["aver", "trans"])
def test_snr_deterministic_gate_matches_flax(snr_type):
    """With the field training=False the gate is sigmoid(log_alpha): no
    draw, equal to flax's from carried parameters."""
    xs = [_normal(24 + i, 4, 4) for i in range(3)]
    jm = jl.SNR(num_out_subnet=2, out_subnet_dim=4, snr_type=snr_type,
                training=False)
    v = flax.core.unfreeze(jm.init(KEY, xs))
    v["params"]["snr_log_alpha"] = _normal(27, 6)
    pm = _load(pl.SNR(3, 4, 2, 4, snr_type=snr_type, training=False), v)
    assert pm.training and not pm.stochastic
    _check(lambda *a: jm.apply(v, list(a)), lambda *a: pm(list(a)), xs,
           diff=[0, 1, 2])


def test_snr_gate_draws_the_hard_concrete_distribution():
    """With training=True (the field, not the module's mode) the gates are
    hard-concrete draws: 64 x 64 gates of one call, summed over the inputs
    (each input is 1), agree with flax's in mean and spread; the port
    draws from its generator only, and raises without one."""
    n, reps = 64, 4
    xs = [np.ones((1, 1), np.float32)] * n
    jm = jl.SNR(num_out_subnet=n, out_subnet_dim=1, snr_type="aver")
    v = jm.init({"params": KEY, "snr": KEY}, xs)
    jsums = np.concatenate([np.concatenate(jm.apply(
        v, xs, rngs={"snr": jax.random.PRNGKey(k)}))[:, 0]
        for k in range(reps)])
    pm = pl.SNR(n, 1, n, 1, snr_type="aver").eval()
    with pytest.raises(RuntimeError, match="no generator"):
        pm([_t(x) for x in xs])
    set_generator(pm, torch.Generator().manual_seed(0))
    psums = np.concatenate([torch.cat(pm([_t(x) for x in xs]))[:, 0].detach().numpy()
                            for _ in range(reps)])
    se = np.sqrt(jsums.var() / len(jsums) + psums.var() / len(psums))
    assert abs(jsums.mean() - psums.mean()) < 4 * se
    np.testing.assert_allclose(psums.std(), jsums.std(), rtol=0.15)
    z = pm.gate("cpu").detach().numpy()
    assert z.min() >= 0.0 and z.max() <= 1.0
    assert (z == 0.0).any() and (z == 1.0).any() and ((z > 0) & (z < 1)).any()


def test_dcn_dropout_drops_by_distribution_in_train_and_not_in_eval():
    """DCN(use_dropout=True): in eval mode the cross layers equal flax's
    with training=False; in train mode each layer's output is kept with
    probability keep_prob (within 4 sigma, as flax's dropout keeps) and a
    kept value is the undropped value / keep_prob exactly (one layer)."""
    keep, d = 0.8, 16
    x = _normal(28, 512, d)
    jm = jl.DCN(layer_num=1, use_dropout=True, keep_prob=keep)
    v = jm.init(KEY, x)
    pm = _load(pl.DCN(d, layer_num=1, use_dropout=True, keep_prob=keep), v)
    _check(lambda x: jm.apply(v, x, training=False), pm.eval(), [x],
           diff=[0])
    full = pm(_t(x)).detach()
    pm.train()
    with pytest.raises(RuntimeError, match="no generator"):
        pm(_t(x))
    set_generator(pm, torch.Generator().manual_seed(1))
    out = pm(_t(x)).detach()
    kept = out != 0
    jout = np.asarray(jm.apply(v, x, training=True,
                               rngs={"dropout": jax.random.PRNGKey(1)}))
    n = out.numel()
    sigma = np.sqrt(keep * (1 - keep) / n)
    for share in (kept.float().mean().item(), float((jout != 0).mean())):
        assert abs(share - keep) < 4 * sigma, share
    assert torch.equal(out[kept], full[kept] / keep)
    assert not torch.equal(pm(_t(x)), out)   # the stream moves on


# ----------------------------------------------------------------------
# losses and ltr
# ----------------------------------------------------------------------

def _ranking_inputs(seed=30, b=6, n=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, (b, n)).astype(np.float32)
    labels[rng.random((b, n)) < 0.2] = -1.0   # invalid items
    labels[0] = 0.0                          # a list without relevance
    labels[1, :2] = -1.0
    logits = rng.normal(size=(b, n)).astype(np.float32)
    return labels, logits


RANKING_WEIGHTS = {"none": None, "scalar": 2.0,
                   "listwise": _normal(31, 6, 1) ** 2,
                   "itemwise": _normal(32, 6, 5) ** 2}
KEYS = [getattr(jlosses.RankingLossKey, k) for k in dir(
    jlosses.RankingLossKey) if k.isupper()]


@pytest.mark.parametrize("key, weights", [
    (k, w) for k in sorted(KEYS) for w in sorted(RANKING_WEIGHTS)
    # ListMLE takes listwise weights only (the JAX loss broadcasts them to
    # [B, 1])
    if not (k == "list_mle_loss" and w == "itemwise")])
def test_ranking_losses_match_jax(key, weights):
    labels, logits = _ranking_inputs()
    w = RANKING_WEIGHTS[weights]
    jfn = getattr(jlosses, key)
    pfn = getattr(plosses, key)
    _check(lambda lg: jfn(labels, lg, w),
           lambda lg: pfn(_t(labels), lg, None if w is None else (
               w if np.isscalar(w) else _t(w))), [logits], diff=[0])


def test_make_loss_fn_weights_and_extra_args_match_jax():
    labels, logits = _ranking_inputs(33)
    keys = sorted(KEYS)
    lw = [0.5 + i for i in range(len(keys))]
    extra = {"approx_ndcg_loss": {"alpha": 5.0}}
    jfn = jlosses.make_loss_fn(keys, lw, extra)
    pfn = plosses.make_loss_fn(keys, lw, extra)
    w = RANKING_WEIGHTS["listwise"]
    _check(lambda lg: jfn(labels, lg, w),
           lambda lg: pfn(_t(labels), lg, _t(w)), [logits], diff=[0])
    with pytest.raises(ValueError, match="unknown ranking loss"):
        plosses.make_loss_fn(["nope"])
    with pytest.raises(ValueError, match="must match"):
        plosses.make_loss_fn(keys, [1.0])


def test_approx_ranks_inverse_max_dcg_and_list_mle_tie_break():
    from monolith_tpu.losses import ltr as jltr
    from monolith_tpu_torch.losses import ltr as pltr
    labels, logits = _ranking_inputs(34)
    _check(jltr.approx_ranks, pltr.approx_ranks, [logits], diff=[0])
    clean = np.maximum(labels, 0.0)
    _close(pltr.inverse_max_dcg(_t(clean)), jltr.inverse_max_dcg(clean))
    # distinct labels: the random tie-break changes nothing
    distinct = np.tile(np.arange(5, dtype=np.float32), (6, 1))
    want = pltr.list_mle_loss(_t(distinct), _t(logits))
    got = pltr.list_mle_loss(_t(distinct), _t(logits),
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(got, want)
    _close(want, jltr.list_mle_loss(distinct, logits))


@pytest.mark.parametrize("negative_weight", [1.0, 0.5])
def test_inbatch_auc_loss_matches_jax(negative_weight):
    logits = _normal(35, 32)
    labels = (np.random.default_rng(36).random(32) > 0.6).astype(np.float32)
    _check(lambda lg: jlosses.inbatch_auc_loss(lg, labels, negative_weight),
           lambda lg: plosses.inbatch_auc_loss(lg, _t(labels),
                                               negative_weight),
           [logits], diff=[0])


@pytest.mark.parametrize("log_q", [False, True])
def test_batch_softmax_loss_matches_jax(log_q):
    u, i = _normal(37, 16, 8), _normal(38, 16, 8)
    q = np.log(np.abs(_normal(39, 16)) + 0.1) if log_q else None
    _check(lambda u, i: jlosses.batch_softmax_loss(u, i, q, temperature=0.5),
           lambda u, i: plosses.batch_softmax_loss(
               u, i, None if q is None else _t(q), temperature=0.5),
           [u, i], diff=[0, 1])


def test_bce_sample_weight_matches_jax():
    logits, weights = _normal(40, 32), np.abs(_normal(41, 32))
    logits[0] = 0.0
    labels = (np.random.default_rng(42).random(32) > 0.5).astype(np.float32)
    _check(lambda lg: jlosses.bce_with_logits(lg, labels, weights),
           lambda lg: plosses.bce_with_logits(lg, _t(labels), _t(weights)),
           [logits], diff=[0])


# ----------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------

@pytest.mark.parametrize("aggregate", [False, True])
def test_feature_insight_matches_jax(aggregate):
    x, w = _normal(43, 4, 9), _normal(44, 9, 3)
    sizes = (2, 3, 4)
    _check(lambda x, w: jops.feature_insight(x, w, sizes, aggregate),
           lambda x, w: pops.feature_insight(x, w, sizes, aggregate),
           [x, w], diff=[0, 1])


def test_fid_counter_discards_the_upstream_gradient():
    """Forward min(counter + step, threshold); backward -step below the
    threshold and 0 at or above it, whatever the upstream gradient."""
    counter = np.array([0.0, 3.0, 4.0, 5.0, 9.0], np.float32)
    up = _normal(45, 5) * 10.0

    def jfn(c):
        return jops.fid_counter(c, 5, step=2.0)

    c = _t(counter).requires_grad_()
    out = pops.fid_counter(c, 5, step=2.0)
    _close(out, jfn(counter))
    (g,) = torch.autograd.grad(torch.sum(out * _t(up)), c)
    jg = jax.grad(lambda c: jnp.sum(jfn(c) * up))(counter)
    _close(g, jg)
    np.testing.assert_array_equal(g.numpy(), [-2.0, -2.0, -2.0, 0.0, 0.0])


def test_gen_seq_mask_matches_jax():
    lengths = np.array([0, 3, 5, 7], np.int32)
    np.testing.assert_array_equal(
        pops.gen_seq_mask(_t(lengths), 5).numpy(),
        np.asarray(jops.gen_seq_mask(jnp.asarray(lengths), 5)))


# ----------------------------------------------------------------------
# trainers: phase 15's module, the training flag, R3
# ----------------------------------------------------------------------

U, B = 512, 64
TASK = dict(embedding_dim=8, capacity_per_shard=4096)


class JaxLibraryModule(nn.Module):
    """The flax twin of chip_smoke.library_task's module, by name."""
    keep_prob: float = 0.9

    @nn.compact
    def __call__(self, pooled, batch, training=False):
        x = jnp.concatenate([pooled[f] for f in chip_smoke.LIB_FEATURES],
                            axis=1)
        h = jl.Dense(256, allow_kernel_norm=True, name="dense")(x)
        h = nn.BatchNorm(use_running_average=not training, name="bn")(h)
        h = jl.LHUCTower((128, 64), name="lhuc")(nn.relu(h), x)
        h = nn.LayerNorm(name="ln")(h)
        c = jl.DCN(layer_num=2, use_dropout=True, keep_prob=self.keep_prob,
                   name="dcn")(x, training=training)
        return {"logits": nn.Dense(1, name="head")(
            jnp.concatenate([c, h], axis=1))[:, 0]}


def jax_library_trainer(keep_prob=1.0):
    @dataclasses.dataclass
    class JaxLibraryTask(JaxDeepFMTask):
        def build_module(self):
            return JaxLibraryModule(keep_prob=keep_prob)

    return JaxTrainer(JaxLibraryTask(**TASK), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=U, new_cap=U),
        log_every=0))


def port_library_trainer(keep_prob=1.0, seed=0, optimizer="adagrad"):
    return Trainer(chip_smoke.library_task(optimizer, keep_prob=keep_prob,
                                           **TASK),
                   TrainerConfig(engine=EngineConfig(unique_cap=U, new_cap=U),
                                 log_every=0, seed=seed), device="cpu")


def _pairs(n, seed):
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=B, seed=seed)
    return [data.batch() for _ in range(n)]


def _seen_again(pairs, seed):
    rng = np.random.default_rng(seed)
    return [({k: np.roll(v, i + 1, axis=0)
              for i, (k, v) in enumerate(sorted(fb.items()))},
             dict(b, label=rng.integers(0, 2, B).astype(np.float32)))
            for fb, b in pairs]


def test_batchnorm_trainer_matches_jax_over_carried_steps():
    """3 JAX steps carried into the port, then 3 steps in each on ids both
    have: losses, predictions, parameters, accumulators and batch_stats
    to rtol 1e-5 / atol 1e-6."""
    pairs = _pairs(3, seed=50)
    jt, pt = jax_library_trainer(), port_library_trainer(seed=3)
    for i, p in enumerate(pairs):
        jt.train_step(*p, ts=100 + i)
    convert.load_state(pt, convert.jax_trainer_state(jt))
    for k, p in enumerate(_seen_again(pairs, seed=1)):
        jo, po = jt.train_step(*p, ts=200 + k), pt.train_step(*p, ts=200 + k)
        assert not any(po["stats"]["new"].values())
        for key in ("loss", "preds"):
            _close(po[key], jo[key], key)
    js, ps = convert.jax_trainer_state(jt), convert.export_state(pt)
    for tree in ("params", "opt_state", "model_state"):
        want, got = convert._flatten(js[tree]), convert._flatten(ps[tree])
        assert sorted(got) == sorted(want), tree
        for k in want:
            _close(got[k], want[k], str(k))
    assert sorted(ps["model_state"]["batch_stats"]) == ["bn"]
    # evaluation runs on the running averages, as JAX's training=False
    evs = _seen_again(pairs, seed=3)
    jev, pev = jt.evaluate(iter(evs)), pt.evaluate(iter(evs))
    for k in ("loss", "auc"):
        np.testing.assert_allclose(pev[k], jev[k], rtol=RTOL, err_msg=k)


def test_jax_trainer_cannot_train_dropout_and_the_port_can():
    """Fault R3 of the reference: its trainer passes no rngs to
    module.apply, so a module that draws in training raises
    InvalidRngError there; the port's trainer seeds the drawing layers'
    generator from (seed, step) and trains it."""
    jt = jax_library_trainer(keep_prob=0.9)
    fb, b = _pairs(1, seed=51)[0]
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jt.train_step(fb, b, ts=0)
    pt = port_library_trainer(keep_prob=0.9)
    losses = [pt.train_step(*p, ts=i)["loss"].item()
              for i, p in enumerate(_pairs(4, seed=51))]
    assert np.isfinite(losses).all()


@pytest.fixture(scope="module")
def dropout_trainer():
    pt = port_library_trainer(keep_prob=0.9)
    for i, p in enumerate(_pairs(3, seed=52)):
        pt.train_step(*p, ts=i)
    return pt


def test_evaluate_runs_in_eval_mode(dropout_trainer):
    """evaluate and predict leave model_state bit for bit as it was; two
    eval forwards of one batch are equal; two train-mode forwards differ
    (dropout); the step runs the module in train mode."""
    pt = dropout_trainer
    before = convert._flatten(pt.model_state)
    fb, b = _pairs(1, seed=53)[0]
    a, c = pt.predict(fb, b), pt.predict(fb, b)
    pt.evaluate(iter(_pairs(2, seed=54)))
    assert not pt.module.training
    assert torch.equal(a, c)
    after = convert._flatten(pt.model_state)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    pooled = {f: torch.randn(B, 9, generator=torch.Generator().manual_seed(
        i)) for i, f in enumerate(chip_smoke.LIB_FEATURES)}
    pt.module.train()
    with torch.no_grad():
        assert not torch.equal(pt.module(pooled)["logits"],
                               pt.module(pooled)["logits"])
    pt.train_step(fb, b, ts=10)
    assert pt.module.training


def test_block_equals_steps_and_restore_continues_exactly(tmp_path):
    """With BatchNorm and dropout: a block of 4 equals 4 train_steps bit
    for bit (losses, parameters, statistics, pools); a restored trainer's
    next step equals the original's bit for bit (the draws are keyed by
    (seed, step))."""
    pairs = _pairs(5, seed=55)
    a, b = port_library_trainer(keep_prob=0.9), port_library_trainer(
        keep_prob=0.9)
    la = [a.train_step(*p, ts=7)["loss"] for p in pairs[:4]]
    lb = b.train_step_block(pairs[:4], ts=7)["loss"]
    assert torch.equal(torch.stack(la), lb)
    sa, sb = convert.export_state(a), convert.export_state(b)
    for tree in ("params", "opt_state", "model_state", "tables"):
        x, y = convert._flatten(sa[tree]), convert._flatten(sb[tree])
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=str(k))
    pckpt.save(a, str(tmp_path))
    c = port_library_trainer(keep_prob=0.9)
    assert pckpt.restore(c, str(tmp_path)) == 4
    oa, oc = a.train_step(*pairs[4], ts=8), c.train_step(*pairs[4], ts=8)
    assert torch.equal(oa["loss"], oc["loss"])
    assert torch.equal(oa["preds"], oc["preds"])


# ----------------------------------------------------------------------
# model_dump and compat
# ----------------------------------------------------------------------

def _frameworkless(d):
    """A dump with the reprs of framework objects (dtypes, callables)
    replaced by a placeholder: the two packages' reprs differ."""
    if isinstance(d, dict):
        return {k: _frameworkless(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_frameworkless(v) for v in d]
    if isinstance(d, str) and (d.startswith("<") or "dtype" in d
                               or d.startswith("torch.")):
        return "<repr>"
    return d


def test_dump_model_is_the_jax_dict():
    """The same task and step give the same dict (parameter paths and
    shapes in flax's names and orientation, their count, tables, features,
    engine config), but for the reprs of framework objects."""
    small = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16, 8))
    jt = JaxTrainer(JaxDeepFMTask(**small), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=512, new_cap=512),
        log_every=0))
    pt = Trainer(DeepFMTask(**small), TrainerConfig(
        engine=EngineConfig(unique_cap=512, new_cap=512), log_every=0),
        device="cpu")
    fb, b = SyntheticCTR(num_users=20, num_items=10, batch_size=32,
                         seed=75).batch()
    jt.train_step(fb, b)
    pt.train_step(fb, b)
    jd = json.loads(json.dumps(jax_dump_model(jt), default=repr))
    pd = json.loads(json.dumps(pdump.dump_model(pt), default=repr))
    assert pd["dense_param_shapes"] == jd["dense_param_shapes"]
    assert pd["dense_param_count"] == jd["dense_param_count"] > 0
    for k in ("task", "step", "features", "tables", "task_config"):
        assert _frameworkless(pd[k]) == _frameworkless(jd[k]), k
    assert sorted(pd) == sorted(jd)


def test_dump_graph_is_the_eval_forward(tmp_path):
    pt = port_library_trainer(keep_prob=0.9)
    fb, b = _pairs(1, seed=56)[0]
    pt.train_step(fb, b, ts=0)
    before = convert._flatten(pt.model_state)
    txt = pdump.dump_graph(pt, fb, b)
    assert "ExportedProgram" in txt and "sigmoid" in txt
    assert "bernoulli" not in txt and "rand" not in txt.replace(
        "operand", "")   # eval mode: no dropout draw
    for k, v in convert._flatten(pt.model_state).items():
        np.testing.assert_array_equal(v, before[k])
    path = tmp_path / "graph.txt"
    pdump.save_graph_dump(pt, str(path), fb, b)
    assert path.read_text() == txt
    pdump.save_model_dump(pt, str(tmp_path / "dump.json"))
    assert json.loads((tmp_path / "dump.json").read_text())["step"] == 1


def _compat_specs(compat):
    """tests/test_infra.py's compat task: returns (tables, features,
    slices)."""
    fm = compat.FeatureFactory(default_capacity=4096)
    fc_user = fm.create_embedding_feature_column(
        "user_id", occurrence_threshold=0, has_bias=True)
    fc_item = fm.create_embedding_feature_column("item_id")
    fc_hist = fm.create_embedding_feature_column(
        "hist_items", shared_name="item_id", combiner="reduce_mean",
        max_seq_length=10)
    u_vec = fc_user.feature_slot.add_feature_slice(8)
    u_bias = fc_user.feature_slot.get_bias_slice()
    i_vec = fc_item.feature_slot.add_feature_slice(8)
    tables, features = fm.build()
    return tables, features, (fc_user, fc_item, fc_hist, u_vec, u_bias,
                              i_vec)


def test_compat_builds_the_jax_specs():
    jt, jf, jcols = _compat_specs(jcompat)
    pt, pf, pcols = _compat_specs(pcompat)
    assert [_frameworkless(pdump._dc_to_dict(t)) for t in pt] == \
        [_frameworkless(pdump._dc_to_dict(t)) for t in jt]
    assert [pdump._dc_to_dict(f) for f in pf] == \
        [pdump._dc_to_dict(f) for f in jf]
    assert pcols[2].feature_slot is pcols[1].feature_slot
    assert pcols[4].start == 0 and pcols[3].start == 1
    assert next(t for t in pt if t.name == "user_id").dim == 9
    assert pf[0].output_dim(9) == 9 and pf[0].slice_dims is None
    assert pcompat.layer_ops.ffm is not None


def _compat_task(compat, jax_side):
    tables, features, (fc_user, fc_item, fc_hist, u_vec, u_bias,
                       i_vec) = _compat_specs(compat)
    if jax_side:
        class M(nn.Module):
            @nn.compact
            def __call__(self, pooled, batch, training=False):
                uv = compat.lookup_embedding_slice(pooled, fc_user, u_vec)
                ub = fc_user.embedding_lookup(pooled, u_bias)[:, 0]
                iv = fc_item.embedding_lookup(pooled, i_vec)
                hv = fc_hist.embedding_lookup(pooled, i_vec)
                x = jnp.concatenate([uv * iv, uv * hv], axis=-1)
                return {"logits": nn.Dense(1, name="head")(x)[:, 0] + ub}
        base = JaxRecTask
    else:
        class M(torch.nn.Module):
            def __init__(self, generator=None):
                super().__init__()
                self.head = pinit.dense(16, 1, generator)

            def forward(self, pooled, batch=None):
                uv = compat.lookup_embedding_slice(pooled, fc_user, u_vec)
                ub = fc_user.embedding_lookup(pooled, u_bias)[:, 0]
                iv = fc_item.embedding_lookup(pooled, i_vec)
                hv = fc_hist.embedding_lookup(pooled, i_vec)
                x = torch.cat([uv * iv, uv * hv], dim=-1)
                return {"logits": self.head(x)[:, 0] + ub}
        base = RecTask

    class T(base):
        def tables(self):
            return tables

        def features(self):
            return features

        def build_module(self, generator=None):
            return M() if jax_side else M(generator)

    return T()


def test_compat_task_trains_as_the_jax_one():
    """The compat task of tests/test_infra.py: 3 JAX steps carried into the
    port, then 3 steps each on ids both have, losses to rtol 1e-5; the
    shared slot holds the history's ids."""
    jt = JaxTrainer(_compat_task(jcompat, True), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=512, new_cap=512),
        log_every=0))
    pt = Trainer(_compat_task(pcompat, False), TrainerConfig(
        engine=EngineConfig(unique_cap=512, new_cap=512), log_every=0),
        device="cpu")
    pairs = _pairs(3, seed=9)
    for i, p in enumerate(pairs):
        jt.train_step(*p, ts=i)
    convert.load_state(pt, convert.jax_trainer_state(jt))
    for k, p in enumerate(_seen_again(pairs, seed=2)):
        jo, po = jt.train_step(*p, ts=10 + k), pt.train_step(*p, ts=10 + k)
        assert not any(po["stats"]["new"].values())
        _close(po["loss"], jo["loss"], "loss")
    assert pt.engine.stores["item_id"].size() == \
        jt.engine.stores["item_id"][0].size() > 30

"""The port's engine (monolith_tpu_torch/embedding/engine.py) against the
JAX package's, after identical warm-up steps carried into the port by
convert.py: the host wire must be bit-identical, the decoded inputs equal,
and the device functions (fused_lookup, pool_features and its backward,
fused_apply) equal within f32 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

CAP, U, B = 2048, 256, 32
TS = 1000


@pytest.fixture(scope="module")
def carried():
    """A JAX trainer after 2 steps, a port trainer carrying its state, and
    a data stream for the next batches."""
    kw = dict(capacity_per_shard=CAP, hidden=(16, 8))
    jt = JaxTrainer(JaxDeepFMTask(**kw), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=U, new_cap=U),
        log_every=0))
    data = SyntheticCTR(num_users=300, num_items=200, batch_size=B, seed=5)
    for i in range(2):
        jt.train_step(*data.batch(), ts=TS + i)
    pt = Trainer(DeepFMTask(**kw), TrainerConfig(
        engine=EngineConfig(unique_cap=U, new_cap=U), log_every=0),
        device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    return jt, pt, data


def _wires(jt, pt, fid_batch, ts):
    """prepare_wire in both packages (advances both stores alike)."""
    jw, jstats = jt.engine.prepare_wire(fid_batch, ts=ts)
    pw, pstats = pt.engine.prepare_wire(fid_batch, ts=ts)
    return jw, pw, jstats, pstats


@pytest.mark.parametrize("i", range(3))
def test_prepare_wire_bit_identical(carried, i):
    jt, pt, data = carried
    fb, _ = data.batch()
    jw, pw, jstats, pstats = _wires(jt, pt, fb, TS + 10 + i)
    assert jw.dtype == pw.dtype == np.int32
    np.testing.assert_array_equal(pw, jw)
    assert pstats == jstats


def test_full_step_wire_bit_identical(carried):
    """Engine region + the batch arrays' words + the step number."""
    jt, pt, data = carried
    fb, b = data.batch()
    layout = JaxTrainer._batch_layout(b)
    jw, _ = jt._pack_full_wire(fb, b, layout, TS + 20, 7)
    playout = pt._batch_layout(b)
    pw = np.empty(pt._full_wire_words(playout), np.int32)
    pt._pack_full_wire(fb, b, playout, TS + 20, 7, out=pw)
    np.testing.assert_array_equal(pw, jw)


def _decoded(carried, ts):
    jt, pt, data = carried
    fb, _ = data.batch()
    jw, pw, _, _ = _wires(jt, pt, fb, ts)
    jin = jt.engine.decode_wire(jnp.asarray(jw), B)["sparse"]
    pin = pt.engine.decode_wire(torch.from_numpy(pw), B)["sparse"]
    return jin, pin


def test_decode_wire_matches_jax(carried):
    jin, pin = _decoded(carried, TS + 30)
    np.testing.assert_array_equal(pin["rows"].numpy(), np.asarray(jin["rows"])[0])
    np.testing.assert_array_equal(pin["new_mask"].numpy(),
                                  np.asarray(jin["new_mask"])[0])
    assert set(pin["index"]) == set(jin["index"])
    for f, idx in jin["index"].items():
        np.testing.assert_array_equal(pin["index"][f].numpy(), np.asarray(idx))
    assert (pin["new_mask"].numpy() > 0).any()   # the batch admits new ids
    assert (pin["index"]["hist_items"].numpy() == -1).any()  # and pads


def test_decode_wire_unsigned_16_bit_indices():
    """Index words decode unsigned: 0x8000..0xFFFE are valid rows, 0xFFFF
    is the sentinel."""
    task = DeepFMTask(capacity_per_shard=16)
    engine = EmbeddingEngine(task.tables(), task.features(),
                             EngineConfig(unique_cap=65535, new_cap=8),
                             device="cpu")
    idx16 = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFE, 0xFFFF], np.uint16)
    rows = np.full(65535, -1, np.int32)
    rows[:3] = [5, 6 | (1 << 30), 0]
    words = [rows]
    for f in task.features():  # batch of 6 for user/item, padded hist
        w = np.full(6 * f.max_length + (6 * f.max_length) % 2, 0xFFFF, np.uint16)
        w[:6] = idx16
        words.append(w.view(np.int32))
    dec = engine.decode_wire(torch.from_numpy(np.concatenate(words)), 6)["sparse"]
    np.testing.assert_array_equal(dec["rows"].numpy()[:4], [5, 6, 0, -1])
    np.testing.assert_array_equal(dec["new_mask"].numpy()[:4], [0, 1, 0, 0])
    np.testing.assert_array_equal(dec["index"]["user_id"].numpy()[:, 0],
                                  [0, 1, 0x7FFF, 0x8000, 0xFFFE, -1])


def test_fused_lookup_matches_jax(carried):
    """Rows already in the pool gather exactly; newly admitted rows are
    fresh init (another PRNG: bounds only) with zero bias and the Adagrad
    init value in their norm columns."""
    jt, pt, _ = carried
    jin, pin = _decoded(carried, TS + 40)
    jrows = np.asarray(jt.engine.fused_lookup(
        jt.table_states, {"sparse": jin}, jax.random.PRNGKey(0), 3)[0]["sparse"])[0]
    prows, unique = pt.engine.fused_lookup(pt.table_states, {"sparse": pin}, 0, 3)
    prows = prows["sparse"].numpy()
    new = pin["new_mask"].numpy() > 0
    np.testing.assert_array_equal(prows[~new], jrows[~new])
    assert np.abs(prows[new, 1:17]).max() <= 0.3
    np.testing.assert_array_equal(prows[new, 0], 0.0)
    np.testing.assert_array_equal(prows[new, 17:33], np.float32(0.01))
    np.testing.assert_array_equal(unique["sparse"].numpy(), prows[:, :17])


def test_pool_features_and_backward_match_jax(carried):
    jt, pt, _ = carried
    jin, pin = _decoded(carried, TS + 50)
    rng = np.random.default_rng(1)
    buf = rng.normal(size=(U, 17)).astype(np.float32)
    cot = {f: rng.normal(size=(B, 17)).astype(np.float32)
           for f in pin["index"]}

    def jfn(b):
        return jt.engine.pool_features({"sparse": b}, {"sparse": jin})

    jpooled, vjp = jax.vjp(jfn, jnp.asarray(buf))
    (jgrad,) = vjp({f: jnp.asarray(c) for f, c in cot.items()})
    leaf = torch.from_numpy(buf).requires_grad_()
    ppooled = pt.engine.pool_features({"sparse": leaf}, {"sparse": pin})
    loss = sum((ppooled[f] * torch.from_numpy(c)).sum() for f, c in cot.items())
    (pgrad,) = torch.autograd.grad(loss, [leaf])
    for f in cot:
        np.testing.assert_allclose(ppooled[f].detach().numpy(),
                                   np.asarray(jpooled[f]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


def test_fused_apply_matches_jax(carried):
    """Per-row optimize + the one scatter, from the same gathered rows and
    unique-row gradients; then the pools agree."""
    jt, pt, _ = carried
    jin, pin = _decoded(carried, TS + 60)
    jprows, _ = jt.engine.fused_lookup(jt.table_states, {"sparse": jin},
                                       jax.random.PRNGKey(0), 4)
    prows = torch.from_numpy(np.array(jprows["sparse"])[0])
    g = np.random.default_rng(2).normal(size=(U, 17)).astype(np.float32) * 0.1
    jstates = jt.engine.fused_apply(jt.table_states, {"sparse": jin}, jprows,
                                    {"sparse": jnp.asarray(g)}, jnp.int32(4))
    pt.engine.fused_apply(pt.table_states, {"sparse": pin},
                          {"sparse": prows}, {"sparse": torch.from_numpy(g)}, 4)
    np.testing.assert_allclose(pt.table_states["sparse"]["data"].numpy(),
                               np.asarray(jstates["sparse"]["data"])[0],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_identical(seed):
    a = JaxSyntheticCTR(num_users=50, num_items=40, batch_size=16, seed=seed)
    b = SyntheticCTR(num_users=50, num_items=40, batch_size=16, seed=seed)
    for _ in range(3):
        (fa, ba), (fb, bb) = a.batch(), b.batch()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])
    assert a.bayes_auc(2000) == b.bayes_auc(2000)

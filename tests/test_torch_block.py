"""The port's block-dispatch training loop on the CPU: against its own
per-step path bit for bit, and against the JAX package's
`train_step_block`, synchronous and 1-step-stale asynchronous.

Small shapes (DeepFM: dim 8, hidden (16,), capacity 2048, unique_cap 256,
batch 16-64; multislot: 2-4 tables, dim 8), inputs made from a seed with
numpy, `init_scale=0.0` wherever the two packages are compared (their init
PRNGs differ). State is carried from the JAX trainer into the port's by
convert.py, the port's TrainerConfig by `convert.port_trainer_config`.

Tolerances against JAX: losses rtol 1e-5; live pool rows, dense parameters
and accumulators atol 1e-5 (f32 sums in another order), as
tests/test_torch_trainer.py states them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.data.synthetic import \
    SyntheticMultiSlot as JaxSyntheticMultiSlot
from monolith_tpu.embedding import optimizers as jopt
from monolith_tpu.embedding.engine import EmbeddingEngine as JaxEngine
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.embedding.spec import TableSegment as JaxSegment
from monolith_tpu.embedding.spec import TableSpec as JaxTableSpec
from monolith_tpu.feature import FeatureConfig as JaxFeatureConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.models.multislot import MultiSlotTask as JaxMultiSlotTask
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticCTR, SyntheticMultiSlot
from monolith_tpu_torch.embedding import optimizers as popt
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.models.multislot import MultiSlotTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

DEEPFM = dict(embedding_dim=8, capacity_per_shard=2048, hidden=(16,),
              init_scale=0.0)
MULTISLOT = dict(num_tables=4, num_slots=10, embedding_dim=8,
                 capacity_per_shard=8192, history_length=6, hidden=(32,),
                 merge=True)
K = 4


def _dc_task(base_cls, opt_mod, lam):
    """DeepFM with both segments under DC(lambda_=lam), in either package."""
    class DCTask(base_cls):
        def tables(self):
            t = super().tables()[0]
            segs = tuple(dataclasses.replace(s, optimizer=opt_mod.DC(
                learning_rate=s.optimizer.learning_rate, lambda_=lam,
                base=s.optimizer)) for s in t.segments)
            return [dataclasses.replace(t, segments=segs)]
    return DCTask(**DEEPFM)


def _pairs(id_sets, batch=16, seed=0):
    """DeepFM batches whose ids are drawn from the given set per step."""
    rng = np.random.default_rng(seed)
    pairs = []
    for ids in id_sets:
        fb = {"user_id": rng.choice(ids, size=(batch, 1)).astype(np.int64),
              "item_id": rng.choice(ids, size=(batch, 1)).astype(np.int64),
              "hist_items": rng.choice(ids, size=(batch, 10)).astype(np.int64)}
        pairs.append((fb, {"label": rng.integers(0, 2, batch)
                           .astype(np.float32)}))
    return pairs


def _state_equal(a: Trainer, b: Trainer):
    for t in a.table_states:
        assert torch.equal(a.table_states[t]["data"],
                           b.table_states[t]["data"]), t
    pa, pb = dict(a.module.named_parameters()), dict(b.module.named_parameters())
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(a.opt_state[n], b.opt_state[n]), n
    assert a.step == b.step


def _assert_matches_jax(jt, pt, tables):
    """Dense parameters, accumulators and live pool rows against JAX."""
    jstate, pstate = convert.jax_trainer_state(jt), convert.export_state(pt)
    for tree in ("params", "opt_state"):
        ref = convert._to_module_tensors(jstate[tree])
        out = convert._to_module_tensors(pstate[tree])
        assert set(out) == set(ref)
        for name in ref:
            np.testing.assert_allclose(out[name], ref[name], atol=1e-5,
                                       rtol=0, err_msg=f"{tree}/{name}")
    for t in tables:
        jf, jr, _, _ = jstate["stores"][t]
        pf, pr, _, _ = pstate["stores"][t]
        np.testing.assert_array_equal(pr[np.argsort(pf)], jr[np.argsort(jf)])
        live = np.sort(jr)
        np.testing.assert_allclose(pstate["tables"][t][0][live],
                                   jstate["tables"][t][0][live],
                                   atol=1e-5, rtol=0, err_msg=t)
    assert pt.step == jt.step


# ----------------------------------------------------------------------
# (a) a block of K equals K sequential steps, bit for bit
# ----------------------------------------------------------------------

def _port_deepfm(task=None, **cfg):
    engine = cfg.pop("engine", {})
    return Trainer(DeepFMTask(**{**DEEPFM, "init_scale": 0.3, **(task or {})}),
                   TrainerConfig(engine=EngineConfig(
                       unique_cap=512, new_cap=512, **engine),
                       log_every=0, seed=7, **cfg), device="cpu")


def _port_multislot_bf16(**engine):
    task = MultiSlotTask(**MULTISLOT, table_dtype=torch.bfloat16,
                         stochastic_rounding=True,
                         dense_dtype=torch.bfloat16)
    return Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=2048, new_cap=2048, **engine), log_every=0, clip_norm=0.5),
        device="cpu")


@pytest.mark.parametrize("staged", [False, True], ids=["packed", "staged"])
@pytest.mark.parametrize("kind", ["deepfm_f32", "deepfm_bf16",
                                  "multislot_bf16"])
def test_block_equals_sequential_steps_bit_for_bit(kind, staged):
    if kind.startswith("deepfm"):
        task = dict(table_dtype=torch.bfloat16, stochastic_rounding=True,
                    dense_dtype=torch.bfloat16) if kind == "deepfm_bf16" else {}
        make = lambda: _port_deepfm(task, clip_norm=0.05)  # noqa: E731
        data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=7)
    else:
        make = _port_multislot_bf16
        data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                                  history_length=6, batch_size=64, seed=3)
    batches = [data.batch() for _ in range(1 + K)]
    seq, blk = make(), make()
    seq_out = [seq.train_step(*b, ts=50 + i) for i, b in enumerate(batches)]
    blk.train_step(*batches[0], ts=50)
    if staged:
        out = blk.train_step_block(batches[1:], staged=blk.stage_block(
            batches[1:], ts=51))
    else:
        out = blk.train_step_block(batches[1:], ts=51)
    assert out["loss"].shape == (K,) and out["preds"].shape == (K, 64)
    assert len(out["stats"]) == K and out["aux"] == {}
    for i in range(K):
        assert torch.equal(out["loss"][i], seq_out[1 + i]["loss"])
        assert torch.equal(out["preds"][i], seq_out[1 + i]["preds"])
        assert out["stats"][i] == seq_out[1 + i]["stats"]
    _state_equal(seq, blk)
    assert blk.step == 1 + K


def test_async_block_on_disjoint_ids_equals_the_synchronous_block():
    """No id in two consecutive steps: zero staleness, so the 1-step-stale
    schedule gives the synchronous block's bits (f32 pool)."""
    pairs = _pairs([np.arange(100 * k, 100 * k + 50) for k in range(1 + K)])
    sync, stale = _port_deepfm(), _port_deepfm(engine=dict(async_optimize=True))
    for tr in (sync, stale):
        tr.train_step(*pairs[0], ts=1)
        tr.train_step_block(pairs[1:], ts=2)
    _state_equal(sync, stale)


# ----------------------------------------------------------------------
# (b), (c) the synchronous and the asynchronous block against JAX's
# ----------------------------------------------------------------------

def _jax_and_port(jtask, ptask, pairs, **engine):
    """A JAX trainer after its first step, a port trainer carrying its
    state and settings, then one block of K in each."""
    jt = JaxTrainer(jtask, JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=256, new_cap=256,
                               **engine),
        clip_norm=0.05, log_every=0, seed=9, steps_per_dispatch=K))
    jt.train_step(*pairs[0], ts=10)
    pt = Trainer(ptask, convert.port_trainer_config(jt.config), device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    start = {t: st["data"].clone() for t, st in pt.table_states.items()}
    jout = jt.train_step_block(pairs[1:], ts=11)
    pout = pt.train_step_block(pairs[1:], ts=11)
    return jt, pt, jout, pout, start


def test_port_trainer_config_carries_the_jax_settings():
    jcfg = JaxTrainerConfig(
        engine=JaxEngineConfig(unique_cap=64, new_cap=32,
                               unique_caps=(("a", 128),),
                               new_caps=(("a", 96),), async_optimize=True),
        clip_norm=2.5, seed=3, log_every=7, metrics_enabled=False,
        steps_per_dispatch=8)
    cfg = convert.port_trainer_config(jcfg)
    assert cfg == TrainerConfig(
        engine=EngineConfig(unique_cap=64, new_cap=32,
                            unique_caps=(("a", 128),), new_caps=(("a", 96),),
                            async_optimize=True),
        clip_norm=2.5, seed=3, log_every=7, metrics_enabled=False,
        steps_per_dispatch=8)
    # the structure-of-arrays state and the int32 index matrices are
    # carried as they are (once refused)
    for kw in (dict(packed="off"), dict(compact_wire=False),
               dict(packed="off", compact_wire=False)):
        got = convert.port_trainer_config(JaxTrainerConfig(
            engine=JaxEngineConfig(num_shards=2, **kw))).engine
        assert got == EngineConfig(num_shards=2, **kw)


def test_sync_block_matches_jax_with_clipping():
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=5)
    pairs = [data.batch() for _ in range(1 + K)]
    jt, pt, jout, pout, _ = _jax_and_port(JaxDeepFMTask(**DEEPFM),
                                          DeepFMTask(**DEEPFM), pairs)
    assert pt.config.clip_norm == 0.05 and pt.config.steps_per_dispatch == K
    np.testing.assert_allclose(pout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(pout["preds"].numpy(),
                               np.asarray(jout["preds"]), rtol=1e-5, atol=1e-6)
    _assert_matches_jax(jt, pt, ["sparse"])
    # the clip did bite: an unclipped port run ends elsewhere
    free = Trainer(DeepFMTask(**DEEPFM), dataclasses.replace(
        pt.config, clip_norm=0.0), device="cpu")
    for i, pair in enumerate(pairs):
        free.train_step(*pair, ts=10 + min(i, 1))
    w = "deep.dense_0.weight"
    assert not torch.allclose(dict(free.module.named_parameters())[w],
                              dict(pt.module.named_parameters())[w],
                              atol=1e-4)


def test_deepfm_bf16_block_matches_jax():
    """DeepFMTask(table_dtype=bf16, dense_dtype=bf16), round to nearest (the
    two packages' rounding noise differs): losses rtol 1e-4, as
    tests/test_torch_multislot_trainer.py holds bf16 pools."""
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=5)
    pairs = [data.batch() for _ in range(1 + K)]
    jt, pt, jout, pout, _ = _jax_and_port(
        JaxDeepFMTask(**DEEPFM, table_dtype=jnp.bfloat16,
                      dense_dtype=jnp.bfloat16),
        DeepFMTask(**DEEPFM, table_dtype=torch.bfloat16,
                   dense_dtype=torch.bfloat16), pairs)
    assert pt.table_states["sparse"]["data"].dtype == torch.bfloat16
    np.testing.assert_allclose(pout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=1e-4)


def test_async_block_matches_jax_with_dc_and_repeated_ids():
    ids = np.arange(0, 50)
    pairs = _pairs([ids] * (1 + K))
    jt, pt, jout, pout, start = _jax_and_port(
        _dc_task(JaxDeepFMTask, jopt, 50.0), _dc_task(DeepFMTask, popt, 50.0),
        pairs, async_optimize=True)
    assert pt.config.engine.async_optimize
    np.testing.assert_allclose(pout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=1e-5)
    _assert_matches_jax(jt, pt, ["sparse"])
    # no update lost: every touched row moved from where the block began
    rows = pt.engine.stores["sparse"].lookup(ids.astype(np.int64))
    touched = rows[rows >= 0]
    assert len(touched) == 50
    pool = pt.table_states["sparse"]["data"]
    assert (pool[touched] != start["sparse"][touched]).any(dim=1).all()
    # staleness was real and DC engaged: lambda 0 ends elsewhere, and so
    # does the synchronous block
    for other in (dict(lam=0.0, async_optimize=True),
                  dict(lam=50.0, async_optimize=False)):
        tr = Trainer(_dc_task(DeepFMTask, popt, other["lam"]),
                     dataclasses.replace(pt.config, engine=dataclasses.replace(
                         pt.config.engine,
                         async_optimize=other["async_optimize"])),
                     device="cpu")
        tr.train_step(*pairs[0], ts=10)
        tr.train_step_block(pairs[1:], ts=11)
        assert not torch.equal(tr.table_states["sparse"]["data"], pool), other


def _swapped_task(base_cls, opt_mod, name, kwargs):
    """DeepFM whose vector segment runs another row optimizer."""
    class Swapped(base_cls):
        def tables(self):
            t = super().tables()[0]
            vec = dataclasses.replace(t.segments[1], optimizer=getattr(
                opt_mod, name)(**kwargs))
            return [dataclasses.replace(t, segments=(t.segments[0], vec))]
    return Swapped(**DEEPFM)


@pytest.mark.parametrize("name,kwargs", [
    ("Adam", dict(learning_rate=0.05)),
    ("Ftrl", dict(learning_rate=0.5, l1_regularization_strength=1e-3)),
    ("GroupAdagrad", dict(learning_rate=0.5)),
    ("Momentum", dict(learning_rate=0.1, use_nesterov=True)),
], ids=["adam", "ftrl", "group_adagrad", "momentum"])
def test_convert_carries_every_optimizers_slots(name, kwargs):
    """Slots travel inside the packed pool at `_layout`'s offsets: a JAX
    pool with other optimizers' slots loads into the port bit for bit, and
    the next block continues as JAX's does."""
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=8)
    pairs = [data.batch() for _ in range(3)]
    jt = JaxTrainer(_swapped_task(JaxDeepFMTask, jopt, name, kwargs),
                    JaxTrainerConfig(engine=JaxEngineConfig(
                        num_shards=1, unique_cap=256, new_cap=256),
                        log_every=0))
    jt.train_step(*pairs[0], ts=1)
    pt = Trainer(_swapped_task(DeepFMTask, popt, name, kwargs),
                 convert.port_trainer_config(jt.config), device="cpu")
    carried = convert.jax_trainer_state(jt)
    convert.load_state(pt, carried)
    np.testing.assert_array_equal(
        pt.table_states["sparse"]["data"].numpy(),
        carried["tables"]["sparse"][0])
    jout = jt.train_step_block(pairs[1:], ts=2)
    pout = pt.train_step_block(pairs[1:], ts=2)
    np.testing.assert_allclose(pout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=1e-5)
    _assert_matches_jax(jt, pt, ["sparse"])


# ----------------------------------------------------------------------
# (d) per-table unique_caps / new_caps
# ----------------------------------------------------------------------

def _caps_engines():
    def build(spec_cls, seg_cls, feat_cls, engine_cls, cfg_cls, **kw):
        tables = [spec_cls(name="small", capacity_per_shard=256,
                           segments=(seg_cls(dim=4),)),
                  spec_cls(name="big", capacity_per_shard=4096,
                           segments=(seg_cls(dim=4),))]
        feats = [feat_cls(name="f_small", table="small", max_length=1,
                          combiner="sum"),
                 feat_cls(name="f_big", table="big", max_length=8,
                          combiner="sum")]
        caps = (("big", 512),)
        return engine_cls(tables, feats, cfg_cls(
            unique_cap=32, new_cap=32, unique_caps=caps,
            new_caps=(("big", 300),)), **kw)
    return (build(JaxTableSpec, JaxSegment, JaxFeatureConfig, JaxEngine,
                  JaxEngineConfig),
            build(TableSpec, TableSegment, FeatureConfig, EmbeddingEngine,
                  EngineConfig, device="cpu"))


def test_per_table_caps_wire_is_bit_identical_to_jax():
    je, pe = _caps_engines()
    assert pe.config.ucap("small") == 32 and pe.config.ucap("big") == 512
    assert pe.config.ncap("small") == 32 and pe.config.ncap("big") == 300
    assert pe.config.max_ucap == 512
    assert pe.wire_words(64) == je.wire_words(64)
    rng = np.random.default_rng(0)
    for step in range(3):
        fb = {"f_small": rng.integers(0, 20, (64, 1)).astype(np.int64),
              "f_big": rng.integers(0, 2000, (64, 8)).astype(np.int64)}
        jw, jstats = je.prepare_wire(fb, ts=step)
        pw, pstats = pe.prepare_wire(fb, ts=step)
        np.testing.assert_array_equal(pw, jw)
        assert pstats == jstats
        if step == 0:  # big admits at most its own new_cap, not the global
            assert pstats["new"]["big"] == 300
            assert pstats["new_rejected"]["big"] > 0
            assert pstats["overflow"]["big"] == 0  # would overflow at 32
        jdec = je.decode_wire(jnp.asarray(jw), 64)
        pdec = pe.decode_wire(torch.from_numpy(pw), 64)
        for t in ("small", "big"):
            assert pdec[t]["rows"].shape == (pe.config.ucap(t),)
            np.testing.assert_array_equal(pdec[t]["rows"].numpy(),
                                          np.asarray(jdec[t]["rows"])[0])
            np.testing.assert_array_equal(pdec[t]["new_mask"].numpy(),
                                          np.asarray(jdec[t]["new_mask"])[0])
            for f in pdec[t]["index"]:
                np.testing.assert_array_equal(
                    pdec[t]["index"][f].numpy(),
                    np.asarray(jdec[t]["index"][f]))


def test_caps_above_the_16_bit_wire_are_refused():
    """Where the JAX package (tests/test_engine.py,
    test_prepare_wire_rejects_oversized_cap) sends a cap above 65535 to
    its multi-array path and refuses the wire, the port's wire carries the
    table wide (int32 index words), so it keeps the fused wire; caps in
    (32768, 65535] ride the unsigned decode of 16-bit words;
    compact_wire=False turns the wire off; a cap above 2**31 - 1 has no
    int32 index and is refused."""
    tables = [TableSpec(name="t", capacity_per_shard=256,
                        segments=(TableSegment(dim=4),))]
    feats = [FeatureConfig(name="f", table="t", max_length=2,
                           combiner="sum")]

    def engine(**cfg):
        return EmbeddingEngine(tables, feats, EngineConfig(**cfg),
                               device="cpu")
    for cfg in (dict(unique_cap=81920),
                dict(unique_cap=64, unique_caps=(("t", 70000),))):
        eng = engine(**cfg)
        assert eng.fuse_wire and eng.wire_capable and eng.wide("t")
        wire, _ = eng.prepare_wire({"f": np.array([[3, -1], [5, 3]],
                                                  np.int64)}, ts=1)
        assert wire.size == eng.config.ucap("t") + 4
        np.testing.assert_array_equal(wire[-4:], [0, -1, 1, 0])
    with pytest.raises(ValueError, match="2147483647"):
        engine(unique_cap=2 ** 31)
    assert engine(unique_cap=40960).fuse_wire
    assert not engine(unique_cap=65535).wide("t")
    assert not engine(unique_cap=1024, compact_wire=False).fuse_wire


def test_async_block_with_per_table_caps_matches_jax():
    task = dict(num_tables=2, num_slots=4, embedding_dim=8,
                capacity_per_shard=4096, history_length=6, hidden=(16,),
                init_scale=0.0)
    caps = dict(unique_caps=(("table_hist", 512),),
                new_caps=(("table_hist", 512),), async_optimize=True)
    jt = JaxTrainer(JaxMultiSlotTask(**task), JaxTrainerConfig(
        engine=JaxEngineConfig(unique_cap=128, new_cap=128, **caps),
        log_every=0, steps_per_dispatch=3))
    data = JaxSyntheticMultiSlot(num_slots=4, vocab_per_slot=300,
                                 history_length=6, batch_size=64, seed=6)
    pairs = [data.batch() for _ in range(4)]
    jt.train_step(*pairs[0], ts=5)
    pt = Trainer(MultiSlotTask(**task),
                 convert.port_trainer_config(jt.config), device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    jout = jt.train_step_block(pairs[1:], ts=6)
    pout = pt.train_step_block(pairs[1:], ts=6)
    np.testing.assert_allclose(pout["loss"].numpy(), np.asarray(jout["loss"]),
                               rtol=1e-5)
    _assert_matches_jax(jt, pt, ["table_0", "table_1", "table_hist"])
    assert pt.engine.stores["table_hist"].size() > \
        pt.engine.stores["table_0"].size()


def test_trains_end_to_end_with_per_table_caps_and_async_blocks():
    task = MultiSlotTask(num_tables=2, num_slots=4, embedding_dim=8,
                         capacity_per_shard=4096, history_length=6,
                         hidden=(16,))
    tr = Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=128, new_cap=128, unique_caps=(("table_hist", 512),),
        new_caps=(("table_hist", 512),), async_optimize=True),
        log_every=0, steps_per_dispatch=3), device="cpu")
    data = SyntheticMultiSlot(num_slots=4, vocab_per_slot=300,
                              history_length=6, batch_size=64, seed=6)
    res = tr.train(iter(data), steps=7)
    assert tr.step == 7 and np.isfinite(res["loss"])
    assert tr.loss_mean.count == 7


# ----------------------------------------------------------------------
# (e) a staged block must be the next dispatch
# ----------------------------------------------------------------------

def test_staged_block_dispatched_out_of_turn_raises():
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=32, seed=2)
    batches = [data.batch() for _ in range(2 + K)]
    tr = _port_deepfm()
    tr.train_step(*batches[0], ts=1)
    staged = tr.stage_block(batches[1:1 + K], ts=2)
    assert staged["base_step"] == 1 and staged["K"] == K
    assert tuple(staged["wires"].shape)[0] == K
    tr.train_step(*batches[1 + K], ts=3)      # another step gets in between
    with pytest.raises(ValueError, match="not the next dispatch"):
        tr.train_step_block(batches[1:1 + K], staged=staged)
    staged = tr.stage_block(batches[1:1 + K], ts=4)
    with pytest.raises(ValueError, match="not the next dispatch"):
        tr.train_step_block(batches[1:K], staged=staged)  # another K


def test_block_refuses_batches_of_differing_layouts():
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=32, seed=2)
    a, b = data.batch(), data.batch()
    b = (b[0], {**b[1], "extra": np.zeros(32, np.float32)})
    tr = _port_deepfm()
    with pytest.raises(ValueError, match="share one layout"):
        tr.train_step_block([a, b], ts=1)


# ----------------------------------------------------------------------
# (f) train() with steps_per_dispatch, hooks and log_every
# ----------------------------------------------------------------------

def _counted(tr):
    """Record the sizes of the groups train() runs: 1 per train_step, K per
    train_step_block, and whether each block came staged."""
    groups = []
    step, block = tr.train_step, tr.train_step_block

    def train_step(*a, **kw):
        groups.append(1)
        return step(*a, **kw)

    def train_step_block(pairs, ts=None, staged=None):
        groups.append((len(pairs), staged is not None))
        return block(pairs, ts=ts, staged=staged)

    tr.train_step, tr.train_step_block = train_step, train_step_block
    return groups


def test_train_blocked_takes_1_4_4_2_steps_and_matches_the_per_step_loop():
    """steps=11, K=4: groups of 4, 4 and 3, each run as a staged block, so
    hooks see steps 4, 8 and 11, as in the JAX package (whose first group
    is stepped one by one, which changes no grouping); the result equals
    the per-step loop's bit for bit."""
    def run(k):
        tr = _port_deepfm(steps_per_dispatch=k)
        groups = _counted(tr)
        calls = []
        data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=7)
        res = tr.train(iter(data), steps=11,
                       hooks=[lambda t, out: calls.append(
                           (t.step, tuple(out["loss"].shape)))])
        return tr, res, groups, calls

    blk, rb, groups, calls = run(4)
    seq, rs, sgroups, scalls = run(1)
    assert groups == [(4, True), (4, True), (3, True)]
    assert calls == [(4, (4,)), (8, (4,)), (11, (3,))]
    assert sgroups == [1] * 11 and [c[0] for c in scalls] == list(range(1, 12))
    assert blk.step == seq.step == 11
    assert blk.loss_mean.count == seq.loss_mean.count == 11
    assert rb["auc"] == rs["auc"] and rb["loss"] == rs["loss"]
    _state_equal(blk, seq)


def test_train_blocked_stops_cleanly_on_stopiteration():
    tr = _port_deepfm(steps_per_dispatch=4)
    groups = _counted(tr)

    def stop_after_first_block(t, out):
        if t.step >= 5:
            raise StopIteration

    data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=7)
    res = tr.train(iter(data), steps=50, hooks=[stop_after_first_block])
    # the hook sees steps 4, then 8, and stops there
    assert tr.step == 8 and groups == [(4, True), (4, True)]
    assert tr.loss_mean.count == 8 and np.isfinite(res["loss"])
    seq = _port_deepfm()
    seq.train(iter(SyntheticCTR(num_users=60, num_items=40, batch_size=64,
                                seed=7)), steps=50,
              hooks=[stop_after_first_block])
    assert seq.step == 5


def test_train_blocked_drains_metrics_at_the_per_step_loops_log_steps(capsys):
    tr = _port_deepfm(steps_per_dispatch=4)
    tr.config.log_every = 3
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=7)
    tr.train(iter(data), steps=11)
    logged = [int(line.split()[1].rstrip(":"))
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("step ")]
    # groups end at steps 4, 8, 11; a multiple of 3 falls in each of them
    # (3; 6; 9)
    assert logged == [4, 8, 11]


@pytest.mark.parametrize("steps", [17, 20])
def test_step_modulo_hook_fires_at_the_jax_trainers_steps(steps):
    """A CheckpointHook-shaped hook (fires when step % every == 0, every =
    2K) under block dispatch fires at the same steps in the port and in the
    JAX trainer; the port's hooks see the ends of its groups of K."""
    every = 2 * K

    def make_hook(seen):
        def hook(t, out):
            if t.step % every == 0:
                seen.append(t.step)
        return hook

    jt = JaxTrainer(JaxDeepFMTask(**DEEPFM), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=256, new_cap=256),
        log_every=0, steps_per_dispatch=K))
    pt = _port_deepfm(steps_per_dispatch=K)
    jseen, pseen, steps_seen = [], [], []
    jt.train(iter(JaxSyntheticCTR(num_users=60, num_items=40, batch_size=32,
                                  seed=7)), steps=steps,
             hooks=[make_hook(jseen)])
    pt.train(iter(SyntheticCTR(num_users=60, num_items=40, batch_size=32,
                               seed=7)), steps=steps,
             hooks=[make_hook(pseen),
                    lambda t, out: steps_seen.append(t.step)])
    assert pseen == jseen == [8, 16]
    assert steps_seen == sorted({*range(K, steps + 1, K), steps})
    assert pt.step == jt.step == steps


def test_metrics_disabled_skips_the_device_accumulator():
    tr = _port_deepfm(steps_per_dispatch=4, metrics_enabled=False)
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=7)
    res = tr.train(iter(data), steps=5)
    assert tr.step == 5 and tr._dev_metrics is None
    assert tr.loss_mean.count == 0 and res["auc"] == 0.5


def test_the_three_seed_domains_cannot_collide():
    """New-row init, fused_apply's rounding and scatter_rows' deferred
    rounding draw from three domains told apart by the seed's top two
    bits, whatever the trainer seed, step and table."""
    from monolith_tpu_torch.embedding import engine
    for seed in (0, 7, 2 ** 40 + 3, 2 ** 70 + 1):
        for step in (0, 1, 10 ** 6):
            for table in (0, 16):
                i = engine._init_seed(seed, step, table)
                r = engine._round_seed(seed, step, table)
                d = engine._defer_seed(seed, step, table)
                assert (i >> 63, r >> 62, d >> 62) == (0, 0b10, 0b11)
                assert max(i, r, d) < 2 ** 64
    # an ordinary seed's init and rounding seeds share their low bits
    assert engine._round_seed(7, 5, 1) == engine._init_seed(7, 5, 1) | 1 << 63
    assert engine._defer_seed(7, 5, 1) == engine._init_seed(7, 5, 1) | 3 << 62

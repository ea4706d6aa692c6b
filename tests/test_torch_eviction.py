"""Expiry eviction in the port against the JAX package, on the CPU: the
host store's expiry and count-aware mapping, the engine's `evict_expired`
and `zero_rows`, a trainer's `evict_expired` and the recycled rows after
it, `checkpoint.save(evict_before_save=True)`, and `StreamingTrainer.run`
with `evict_interval_steps` in both modes.

Small shapes (tests/test_engine.py's and tests/test_tiered.py's: capacity
64-256, DeepFM dim 8, hidden (8,), batches of 8-32), inputs made from a
seed with numpy, `init_scale=0.0` where trainers are compared (their init
PRNGs differ). Tolerances: stores, freed rows and zeroed rows exact; losses
rtol 1e-5; pools atol 1e-6 (f32 sums in another order).
"""

import types

import numpy as np
import pytest
import torch

from monolith_tpu.embedding import initializers as jinit
from monolith_tpu.embedding import optimizers as jopt
from monolith_tpu.embedding.engine import EmbeddingEngine as JaxEngine
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.embedding.host_store import Batcher as JaxBatcher
from monolith_tpu.embedding.host_store import FilterKind as JaxFilterKind
from monolith_tpu.embedding.host_store import HostStore as JaxHostStore
from monolith_tpu.embedding.spec import EvictionConfig as JaxEviction
from monolith_tpu.embedding.spec import TableSegment as JaxSegment
from monolith_tpu.embedding.spec import TableSpec as JaxTableSpec
from monolith_tpu.feature import FeatureConfig as JaxFeatureConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training import streaming as jstreaming
from monolith_tpu.training import trainer as jtrainer_mod
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.embedding import engine as pengine
from monolith_tpu_torch.embedding import initializers as pinit
from monolith_tpu_torch.embedding import optimizers as popt
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.embedding.host_store import Batcher, FilterKind, HostStore
from monolith_tpu_torch.embedding.spec import (EvictionConfig, TableSegment,
                                               TableSpec)
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training import streaming as pstreaming
from monolith_tpu_torch.training import trainer as ptrainer_mod
from monolith_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=64, hidden=(8,),
            ttl_seconds=3600, init_scale=0.0)


def ids_batch(ids, label=1.0):
    ids = np.asarray(ids, np.int64)[:, None]
    return ({"user_id": ids, "item_id": ids + 10_000,
             "hist_items": np.full((len(ids), 10), -1, np.int64)},
            {"label": np.full(len(ids), label, np.float32)})


def twins(tiered=False, seed=3, **task):
    """A JAX trainer and a port trainer from one carried state, both with
    empty host stores."""
    task = {**TASK, **task}
    jt = JaxTrainer(JaxDeepFMTask(**task), JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=1, unique_cap=256, new_cap=256,
                               tiered=tiered), log_every=0, seed=seed))
    fb, b = ids_batch([10 ** 9])
    inputs, _ = jt.engine.prepare_batch(fb, ts=0)
    jt._maybe_init(inputs, b)
    jt.engine.stores["sparse"][0].restore(np.empty(0, np.int64),
                                          np.empty(0, np.int32))
    pt = Trainer(DeepFMTask(**task), convert.port_trainer_config(jt.config),
                 device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    return jt, pt


def step_both(jt, pt, pair, ts):
    lj = float(jt.train_step(*pair, ts=ts)["loss"])
    lp = float(pt.train_step(*pair, ts=ts)["loss"])
    np.testing.assert_allclose(lp, lj, rtol=1e-5)


def assert_tables_equal(jt, pt, atol=1e-6):
    js, ps = convert.jax_trainer_state(jt), convert.export_state(pt)
    for t in js["stores"]:
        a, b = js["stores"][t], ps["stores"][t]
        oa, ob = np.argsort(a[0]), np.argsort(b[0])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[oa], y[ob])
        np.testing.assert_allclose(ps["tables"][t].reshape(-1, 128),
                                   js["tables"][t].reshape(-1, 128),
                                   atol=atol)


# ----------------------------------------------------------------------
# the host store and the batcher
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind,threshold", [("NONE", 1), ("SLIDING", 2),
                                            ("PROBABILISTIC", 2)])
def test_map_train_pos_with_counts_and_expiry_match_jax(kind, threshold):
    """map_train_pos (with and without occurrence counts) and
    evict_expired (rows, and rows with fids) on twin stores."""
    kw = dict(row_capacity=40, admit_threshold=threshold,
              filter_capacity=256 if kind != "NONE" else 0, seed=5)
    a = JaxHostStore(filter_kind=getattr(JaxFilterKind, kind), **kw)
    b = HostStore(filter_kind=getattr(FilterKind, kind), **kw)
    rng = np.random.default_rng(1)
    for step in range(10):
        fids = np.unique(rng.integers(0, 60, 20)).astype(np.int64)
        counts = rng.integers(1, 4, fids.size).astype(np.int32)
        use = counts if step % 2 else None
        ra = a.map_train_pos(fids, ts=step * 10, new_cap=8, counts=use)
        rb = b.map_train_pos(fids, ts=step * 10, new_cap=8, counts=use)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(y, x)
        assert b.last_rejected == a.last_rejected
        if step % 3 == 2:
            fa = a.evict_expired(step * 10 - 15, return_fids=step % 2 == 0)
            fb = b.evict_expired(step * 10 - 15, return_fids=step % 2 == 0)
            for x, y in zip(fa if isinstance(fa, tuple) else (fa,),
                            fb if isinstance(fb, tuple) else (fb,)):
                np.testing.assert_array_equal(y, x)
        assert b.size() == a.size()
    np.testing.assert_array_equal(b.evict_expired(10 ** 6),
                                  a.evict_expired(10 ** 6))
    assert b.size() == 0 and len(b.evict_expired(10 ** 6)) == 0


def test_dedup_counts_matches_jax():
    rng = np.random.default_rng(2)
    a, b = JaxBatcher(expected_unique=16), Batcher(expected_unique=16)
    for cap in (64, 8):
        values = rng.integers(-1, 30, 100).astype(np.int64)
        for x, y in zip(a.dedup_counts(values, 1, cap),
                        b.dedup_counts(values, 1, cap)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


# ----------------------------------------------------------------------
# the engine: evict_expired and zero_rows
# ----------------------------------------------------------------------

def engines(ttls=(3600, 0), dtype=torch.float32):
    """Twin engines with a table per ttl (tests/test_engine.py's shape:
    Adagrad, zero init, capacity 256)."""
    jt, pt = [], []
    for i, ttl in enumerate(ttls):
        jt.append(JaxTableSpec(
            name=f"t{i}", capacity_per_shard=256,
            segments=(JaxSegment(dim=4, optimizer=jopt.Adagrad(
                learning_rate=0.5), initializer=jinit.Zeros()),),
            eviction=JaxEviction(ttl_seconds=ttl)))
        pt.append(TableSpec(
            name=f"t{i}", capacity_per_shard=256,
            segments=(TableSegment(dim=4, optimizer=popt.Adagrad(
                learning_rate=0.5), initializer=pinit.Zeros()),),
            eviction=EvictionConfig(ttl_seconds=ttl), dtype=dtype))
    jf = [JaxFeatureConfig(name=f"f{i}", table=f"t{i}", max_length=3)
          for i in range(len(ttls))]
    pf = [FeatureConfig(name=f"f{i}", table=f"t{i}", max_length=3)
          for i in range(len(ttls))]
    return (JaxEngine(jt, jf, JaxEngineConfig(unique_cap=64, new_cap=32)),
            EmbeddingEngine(pt, pf, EngineConfig(unique_cap=64, new_cap=32),
                            device="cpu"))


def test_evict_expired_frees_the_same_rows_as_jax():
    je, pe = engines()
    rng = np.random.default_rng(3)
    for step in range(8):
        fb = {f"f{i}": rng.integers(-1, 50, (6, 3)).astype(np.int64)
              for i in range(2)}
        je.prepare_batch(fb, ts=step * 100)
        pe.prepare_batch(fb, ts=step * 100)
        if step % 3 == 2:
            jf = je.evict_expired(step * 100 - 150)
            pf = pe.evict_expired(step * 100 - 150)
            assert set(pf) == set(jf) == {"t0"}        # t1 has no ttl
            np.testing.assert_array_equal(pf["t0"], jf["t0"])
            assert pf["t0"].dtype == np.int64 and len(pf["t0"]) > 0
        for t in ("t0", "t1"):
            assert pe.stores[t].size() == je.stores[t][0].size()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_rows_clears_params_and_slots_and_leaves_the_rest(dtype):
    """zero_rows zeroes every column of the freed rows (params and the
    Adagrad slot), leaves every other row bit for bit, pads its one K2 to a
    power of two with -1, and equals JAX's zero_rows on the same state."""
    je, pe = engines(dtype=dtype)
    states = pe.create_states()
    g = torch.Generator().manual_seed(0)
    for st in states.values():
        st["data"].copy_(torch.randn(st["data"].shape, generator=g))
    before = {t: st["data"].clone() for t, st in states.items()}
    freed = {"t0": np.array([3, 7, 200, 0, 5], np.int64),
             "t1": np.empty(0, np.int64)}
    calls = []
    real = pengine.scatter_rows

    def spy(pool, rows, values):
        calls.append((rows.clone(), values.dtype))
        return real(pool, rows, values)

    pengine.scatter_rows = spy
    try:
        out = pe.zero_rows(states, freed)
    finally:
        pengine.scatter_rows = real
    assert out is states
    assert len(calls) == 1                 # one K2, none for an empty list
    rows, vdtype = calls[0]
    assert vdtype == dtype
    assert rows.tolist() == [3, 7, 200, 0, 5, -1, -1, -1]
    data = states["t0"]["data"]
    assert not data[freed["t0"]].any()
    keep = np.setdiff1d(np.arange(256), freed["t0"])
    assert torch.equal(data[keep].view(torch.int16),
                       before["t0"][keep].view(torch.int16))
    assert torch.equal(states["t1"]["data"], before["t1"])
    # JAX's zero_rows on the same (f32) state
    import jax.numpy as jnp
    jstate = {"t0": {"data": jnp.asarray(before["t0"].float().numpy()[None])}}
    jout = je.zero_rows(jstate, {"t0": freed["t0"]})
    np.testing.assert_array_equal(data.float().numpy(),
                                  np.asarray(jout["t0"]["data"][0]))


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------

def test_trainer_evict_then_recycle_matches_jax():
    """Evicting expired ids frees and zeroes their rows; new ids take the
    recycled rows with init values: losses, stores and pools equal JAX's."""
    jt, pt = twins()
    old, new = ids_batch(np.arange(1, 9)), ids_batch(np.arange(20, 28))
    for _ in range(2):
        step_both(jt, pt, old, ts=100)
    step_both(jt, pt, new, ts=500)
    freed_j = jt.evict_expired(400)
    freed_p = pt.evict_expired(400)
    np.testing.assert_array_equal(freed_p["sparse"], freed_j["sparse"])
    assert len(freed_p["sparse"]) == 16
    assert not pt.table_states["sparse"]["data"][
        torch.from_numpy(freed_p["sparse"])].any()
    assert pt.engine.stores["sparse"].size() == 16
    assert_tables_equal(jt, pt)
    recycled = ids_batch(np.arange(40, 48))
    for ts in (600, 700):
        step_both(jt, pt, recycled, ts=ts)
    rows = pt.engine.stores["sparse"].lookup(recycled[0]["user_id"].ravel())
    assert set(rows.tolist()) <= set(freed_p["sparse"].tolist())
    assert_tables_equal(jt, pt)


def test_evict_before_save_matches_jax(tmp_path):
    """save(evict_before_save=True) evicts at now - ttl first: the ids last
    updated two ttls ago leave the store and their rows read zero, as in
    the JAX package; the checkpoint holds only the rest."""
    import time as _time
    now = int(_time.time())
    jt, pt = twins(ttl_seconds=1000)
    step_both(jt, pt, ids_batch(np.arange(1, 5)), ts=now - 5000)
    step_both(jt, pt, ids_batch(np.arange(10, 14)), ts=now)
    jckpt.save(jt, str(tmp_path / "jax"), evict_before_save=True)
    path = pckpt.save(pt, str(tmp_path / "port"), evict_before_save=True)
    assert pt.engine.stores["sparse"].size() == 8
    assert_tables_equal(jt, pt)
    z = np.load(f"{path}/tables/sparse-s0.npz")
    assert sorted(z["fids"].tolist()) == sorted(
        list(range(10, 14)) + list(range(10_010, 10_014)))


class _Clock:
    """time.time for both packages' trainer and streaming modules: set by
    the data stream before each step."""

    def __init__(self):
        self.now = 0

    def time(self):
        return float(self.now)

    def stream(self, pairs, dt):
        for i, pair in enumerate(pairs):
            self.now = 10_000 + i * dt
            yield pair


@pytest.mark.parametrize("tiered", [False, True])
def test_streaming_run_evicts_on_its_interval_like_jax(monkeypatch, tiered):
    """StreamingTrainer.run with evict_interval_steps=2 and the clock
    patched in both packages' streaming and trainer modules: every second
    step expires the ids not seen for more than the ttl, by evict (freed
    rows zeroed) or by spill (rows archived, then revived when their ids
    come back); stores, pools and archives equal JAX's."""
    clock = _Clock()
    for mod in (jstreaming, jtrainer_mod, pstreaming, ptrainer_mod):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=clock.time))
    jt, pt = twins(tiered=tiered, ttl_seconds=150)
    waves = [ids_batch(np.arange(w * 8, w * 8 + 8) % 20) for w in range(8)]
    cfg = dict(sync_interval_steps=0, evict_interval_steps=2)
    jres = jstreaming.StreamingTrainer(
        jt, None, jstreaming.StreamingConfig(**cfg)).run(
            clock.stream(waves, 100))
    pres = pstreaming.StreamingTrainer(
        pt, None, pstreaming.StreamingConfig(**cfg)).run(
            clock.stream(waves, 100))
    assert pres["steps"] == jres["steps"] == 8
    np.testing.assert_allclose(pres["loss"], jres["loss"], rtol=1e-5)
    assert_tables_equal(jt, pt)
    if tiered:
        a = pt.engine.archives["sparse"]
        b = jt.engine.archives["sparse"][0]
        assert (a.spilled, a.revived, a.size()) == \
            (b.spilled, b.revived, b.size())
        assert a.spilled > 0 and a.revived > 0
    else:
        assert pt.engine.stores["sparse"].size() < 8 * 16

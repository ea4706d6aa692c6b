"""The sharded engine's host side and ROADMAP item C against the JAX
package, in process (the trainer over gloo ranks is
tests/test_torch_sharded.py):

- `prepare_batch` at S = 2, 4 (the port's `prepare_shards`) and
  `prepare_batch_a2a` with and without admission (so `Batcher2D.dedup2`):
  every array, its dtype and every stat equal to the JAX engine's, step
  after step on twin engines; `Batcher2D` itself on the same calls;
- expiry on every shard, rows numbered as the JAX engine numbers them;
- local_shards and the per-shard archives (as the JAX engine builds
  them), the refusals that remain (per-table caps with S > 1, the
  Estimator's num_shards without a process group) and
  `port_trainer_config`'s sharded settings;
- item C: `Constants` exactly through `table.init_packed`, `RandomNormal`
  by mean and standard deviation, `NAMED_INITIALIZERS`' keys, and
  `HostStore.filter_estimate` on the same stream as the JAX store.
"""

import numpy as np
import pytest
import torch

from monolith_tpu.embedding import host_store as jhs
from monolith_tpu.embedding import initializers as jinit
from monolith_tpu.embedding import table as jtable
from monolith_tpu.embedding.engine import EmbeddingEngine as JaxEngine
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.embedding.spec import TableSegment as JaxSegment
from monolith_tpu.embedding.spec import TableSpec as JaxTableSpec
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.embedding import host_store as phs
from monolith_tpu_torch.embedding import initializers as pinit
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.estimator import Estimator, RunnerConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training.trainer import TrainerConfig

torch.set_num_threads(1)


def twin_engines(S, threshold=1, ttl_seconds=0, **engine):
    kw = dict(embedding_dim=4, capacity_per_shard=256,
              admission_threshold=threshold, ttl_seconds=ttl_seconds)
    jtask, ptask = JaxDeepFMTask(**kw), DeepFMTask(**kw)
    cfg = dict(num_shards=S, unique_cap=64, new_cap=24, **engine)
    je = JaxEngine(jtask.tables(), jtask.features(), JaxEngineConfig(**cfg),
                   seed=4)
    pe = EmbeddingEngine(ptask.tables(), ptask.features(),
                         EngineConfig(**cfg), seed=4, device="cpu")
    return je, pe


def random_fids(rng, B=16):
    return {"user_id": rng.integers(-1, 90, (B, 1)).astype(np.int64),
            "item_id": rng.integers(60, 200, (B, 1)).astype(np.int64),
            "hist_items": rng.integers(-1, 200, (B, 10)).astype(np.int64)}


def assert_same_arrays(p, j, what):
    """Equal values and dtypes, dict for dict."""
    if isinstance(j, dict):
        assert set(p) == set(j), what
        for k in j:
            assert_same_arrays(p[k], j[k], f"{what} {k}")
        return
    j = np.asarray(j)
    assert p.dtype == j.dtype, (what, p.dtype, j.dtype)
    np.testing.assert_array_equal(p, j, err_msg=what)


@pytest.mark.parametrize("S,threshold", [(2, 1), (4, 1), (2, 2), (4, 3)])
def test_prepare_batch_matches_jax(S, threshold):
    je, pe = twin_engines(S, threshold)
    rng = np.random.default_rng(S * 10 + threshold)
    for step in range(6):
        fb = random_fids(rng)
        jin, js = je.prepare_batch(fb, ts=step)
        pin, ps = pe.prepare_batch(fb, ts=step)
        assert_same_arrays(pin, jin, f"step {step}")
        assert ps == js
        assert pin["sparse"]["rows"].shape == (S, 64)
    for s in range(S):
        for a, b in zip(pe.shard_stores["sparse"][s].save(),
                        je.stores["sparse"][s].save()):
            np.testing.assert_array_equal(a, b)


def test_index_dtype_follows_the_jax_rule():
    """16-bit indices while S*U <= 32768, int32 above (the sharded step
    uploads int32 words either way)."""
    for S, U, dt in [(2, 16384, np.int16), (4, 16384, np.int32),
                     (2, 32768, np.int32)]:
        cfg, jcfg = EngineConfig(num_shards=S, unique_cap=U), \
            JaxEngineConfig(num_shards=S, unique_cap=U)
        assert cfg.index_dtype == jcfg.index_dtype == dt
        assert cfg.pos_dtype == jcfg.pos_dtype
        assert cfg.effective_bucket_cap == jcfg.effective_bucket_cap


@pytest.mark.parametrize("S,threshold,bucket_cap",
                         [(2, 1, 0), (4, 1, 0), (2, 2, 0), (4, 2, 0),
                          (4, 1, 3)])
def test_prepare_batch_a2a_matches_jax(S, threshold, bucket_cap):
    """Without admission (Batcher2D.dedup) and with it (dedup2); with
    bucket_cap 3 many ids overflow their buckets and are counted."""
    je, pe = twin_engines(S, threshold, exchange="a2a",
                          bucket_cap=bucket_cap)
    rng = np.random.default_rng(S + threshold + bucket_cap)
    overflow = 0
    for step in range(6):
        fb = random_fids(rng)
        jin, js = je.prepare_batch_a2a(fb, ts=step)
        pin, ps = pe.prepare_batch_a2a(fb, ts=step)
        assert_same_arrays(pin, jin, f"step {step}")
        assert ps == js
        overflow += ps["overflow"]["sparse"]
    if bucket_cap:
        assert overflow > 100


@pytest.mark.parametrize("occurrences", [False, True])
def test_batcher2d_matches_jax(occurrences):
    rng = np.random.default_rng(5)
    jb, pb = jhs.Batcher2D(64), phs.Batcher2D(64)
    for _ in range(3):
        values = rng.integers(-1, 300, 4 * 60).astype(np.int64)
        args = dict(num_batch_shards=4, num_shards=2, global_cap=96,
                    bucket_cap=20)
        fn = "dedup2" if occurrences else "dedup"
        got, want = getattr(pb, fn)(values, **args), \
            getattr(jb, fn)(values, **args)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_expiry_numbers_rows_by_shard_as_jax():
    je, pe = twin_engines(2, ttl_seconds=10)
    rng = np.random.default_rng(8)
    for step in range(6):
        fb = random_fids(rng)
        je.prepare_batch(fb, ts=step * 100)
        pe.prepare_batch(fb, ts=step * 100)
    jf, pf = je.evict_expired(250), pe.evict_expired(250)
    assert set(pf) == set(jf) == {"sparse"}
    np.testing.assert_array_equal(pf["sparse"], jf["sparse"])
    assert (pf["sparse"] >= 256).any() and (pf["sparse"] < 256).any()


def test_single_shard_prepare_keeps_its_layout():
    """At S = 1 prepare_batch drops the shard axis and widens the index
    to int32, as before; prepare_shards keeps JAX's arrays."""
    je, pe = twin_engines(1)
    fb = random_fids(np.random.default_rng(1))
    pin, _ = pe.prepare_shards(fb, ts=0)
    jin, _ = je.prepare_batch(fb, ts=0)
    assert_same_arrays(pin, jin, "prepare_shards")
    _, pe2 = twin_engines(1)
    flat, _ = pe2.prepare_batch(fb, ts=0)
    np.testing.assert_array_equal(flat["sparse"]["rows"],
                                  jin["sparse"]["rows"][0])
    assert flat["sparse"]["index"]["hist_items"].dtype == np.int32


def test_refusals_that_remain():
    """The local shards and the per-shard archives that the multi-host
    trainer runs on, and the tiered prepare of S shards (once refused),
    and the refusals that remain: the per-table caps, an unknown
    exchange, the single-shard wire of a sharded engine, a sharded
    Estimator in one process (the ranks are started by train.main or
    parallel.launch)."""
    task = DeepFMTask(embedding_dim=4, capacity_per_shard=64)

    def engine(**cfg):
        return EmbeddingEngine(task.tables(), task.features(),
                               EngineConfig(**cfg), device="cpu")
    # a process that holds only shard 1: its store and archive, as the
    # JAX engine's local_shards builds them (None elsewhere)
    local = engine(num_shards=2, local_shards=(1,), tiered=True)
    jtask = JaxDeepFMTask(embedding_dim=4, capacity_per_shard=64)
    jlocal = JaxEngine(jtask.tables(), jtask.features(), JaxEngineConfig(
        num_shards=2, local_shards=(1,), tiered=True))
    for t in ("sparse",):
        assert [s is None for s in local.shard_stores[t]] == \
            [s is None for s in jlocal.stores[t]] == [True, False]
        assert [a is None for a in local.shard_archives[t]] == \
            [a is None for a in jlocal.archives[t]] == [True, False]
    assert local.shard == 1 and local.stores == {} and local.archives == {}
    assert local.store_of("sparse") is local.shard_stores["sparse"][1]
    assert local.archive_of("sparse") is local.shard_archives["sparse"][1]
    fb = random_fids(np.random.default_rng(0))
    for prepare in (local.prepare_shards, local.prepare_batch_a2a):
        with pytest.raises(ValueError, match="multi-host trainer"):
            prepare(fb, ts=0)
    # a tiered engine of S shards now prepares (its revives with a shard
    # axis; tests/test_torch_sharded_tiered.py holds them against JAX's)
    tiered = engine(num_shards=2, tiered=True, unique_cap=64, new_cap=64)
    inputs, _ = tiered.prepare_shards(fb, ts=0)
    assert inputs["sparse"]["revive_pos"].shape == (2, 0)
    assert inputs["sparse"]["revive_values"].shape[:2] == (2, 0)
    with pytest.raises(ValueError, match="local_shards"):
        engine(num_shards=2, local_shards=(2,))
    with pytest.raises(ValueError, match="per-table"):
        engine(num_shards=2, unique_caps=(("sparse", 8),))
    with pytest.raises(ValueError, match="exchange"):
        engine(num_shards=2, exchange="ring")
    sharded = engine(num_shards=2, unique_cap=40000)   # no 16-bit wire
    assert sharded.stores == {} and len(sharded.shard_stores["sparse"]) == 2
    with pytest.raises(ValueError, match="prepare_shards"):
        sharded.prepare_wire(random_fids(np.random.default_rng(0)), ts=0)
    with pytest.raises(ValueError, match="parallel.launch"):
        Estimator(task, RunnerConfig(num_shards=2), device="cpu")


def test_port_trainer_config_carries_the_sharded_settings():
    jcfg = JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=4, unique_cap=256, new_cap=64,
                               exchange="a2a", bucket_cap=96),
        clip_norm=1.5, seed=3, steps_per_dispatch=4)
    assert convert.port_trainer_config(jcfg) == TrainerConfig(
        engine=EngineConfig(num_shards=4, unique_cap=256, new_cap=64,
                            exchange="a2a", bucket_cap=96),
        clip_norm=1.5, seed=3, steps_per_dispatch=4)
    # the structure-of-arrays state and the int32 index matrices are
    # carried (once refused)
    for kw in (dict(packed="off"), dict(compact_wire=False)):
        got = convert.port_trainer_config(JaxTrainerConfig(
            engine=JaxEngineConfig(num_shards=2, **kw))).engine
        assert got == EngineConfig(num_shards=2, **kw)


# ----------------------------------------------------------------------
# item C
# ----------------------------------------------------------------------

def _const_specs(value):
    def spec(Table, Segment, init):
        return Table(name="t", capacity_per_shard=64,
                     segments=(Segment(dim=3, initializer=init(value)),
                               Segment(dim=5)))
    return (spec(JaxTableSpec, JaxSegment, jinit.Constants),
            spec(TableSpec, TableSegment, pinit.Constants))


@pytest.mark.parametrize("value", [0.0, 0.25, -1.5])
def test_constants_initializer_is_exact_through_init_packed(value):
    jspec, pspec = _const_specs(value)
    import jax
    jrows = np.asarray(jtable.init_packed(jspec, jax.random.PRNGKey(0), 32))
    prows = ptable.init_packed(pspec, torch.Generator().manual_seed(0), 32,
                               "cpu").numpy()
    np.testing.assert_array_equal(prows[:, :3], jrows[:, :3])
    np.testing.assert_array_equal(prows[:, :3], np.float32(value))
    np.testing.assert_array_equal(prows[:, 8:], jrows[:, 8:])


@pytest.mark.parametrize("mean,stddev", [(0.0, 0.05), (0.5, 2.0)])
def test_random_normal_by_distribution(mean, stddev):
    import jax
    n = 200_000
    p = pinit.RandomNormal(mean, stddev).init(
        torch.Generator().manual_seed(1), (n,), "cpu").numpy()
    j = np.asarray(jinit.RandomNormal(mean, stddev).init(
        jax.random.PRNGKey(1), (n,)))
    for x in (p, j):
        assert abs(x.mean() - mean) < 5 * stddev / np.sqrt(n)
        assert abs(x.std() / stddev - 1) < 0.01
    assert p.dtype == j.dtype == np.float32


def test_named_initializers_match_jax():
    assert set(pinit.NAMED_INITIALIZERS) == set(jinit.NAMED_INITIALIZERS)
    for name, cls in pinit.NAMED_INITIALIZERS.items():
        assert cls.__name__ == jinit.NAMED_INITIALIZERS[name].__name__


@pytest.mark.parametrize("threshold", [3, 10])
def test_filter_estimate_matches_jax(threshold):
    def make(mod):
        return mod.HostStore(row_capacity=64,
                             filter_kind=mod.FilterKind.SLIDING,
                             admit_threshold=threshold)
    js, ps = make(jhs), make(phs)
    rng = np.random.default_rng(threshold)
    for step in range(5):
        fids = rng.integers(0, 40, 60).astype(np.int64)
        js.map_train(fids, ts=step)
        ps.map_train(fids, ts=step)
        for fid in range(45):
            assert ps.filter_estimate(fid) == js.filter_estimate(fid)
    assert ps.filter_estimate(7) > 0
    assert phs.HostStore(row_capacity=8).filter_estimate(7) == \
        jhs.HostStore(row_capacity=8).filter_estimate(7)


def test_each_shard_draws_its_own_init():
    """New-row init is keyed by (seed, step, table, shard): shard 0 keeps
    the single-shard draw, another shard draws apart, each from the same
    distribution (bounds and mean of RandomUniform(-s, s))."""
    from monolith_tpu_torch.embedding.engine import _init_seed
    assert len({_init_seed(3, 7, 0, s) for s in range(8)}) == 8
    assert _init_seed(3, 7, 0, 0) == _init_seed(3, 7, 0)
    s = 0.05
    task = DeepFMTask(embedding_dim=16, capacity_per_shard=4096,
                      init_scale=s)
    draws = []
    for shard in (0, 1):
        e = EmbeddingEngine(task.tables(), task.features(),
                            EngineConfig(num_shards=2, unique_cap=2048),
                            device="cpu")
        e.shard = shard
        rows = torch.arange(2048, dtype=torch.int32)
        inputs = {"sparse": {"rows": rows,
                             "new_mask": torch.ones(2048, dtype=torch.uint8)}}
        _, unique = e.fused_lookup(e.create_states(), inputs, seed=3, step=7)
        draws.append(unique["sparse"][:, 1:].numpy())
    assert not np.array_equal(draws[0], draws[1])
    for d in draws:
        assert d.min() >= -s and d.max() <= s
        assert abs(d.mean()) < 3 * s / np.sqrt(3.0) / np.sqrt(d.size)

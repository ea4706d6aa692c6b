"""What checkpoint, serving and streaming call on the port's host store
(touched-key tracking, admission-filter save/restore, `Batcher.dedup`,
`shard_of`), against the JAX package's wrappers over the same C++: equal
outputs on the same calls, made from a seed with numpy."""

import numpy as np
import pytest

from monolith_tpu.embedding import host_store as jhs
from monolith_tpu.embedding.engine import EmbeddingEngine as JaxEngine
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding import host_store as phs
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask


def _fids(seed, n, hi=5000):
    return np.random.default_rng(seed).integers(0, hi, size=n).astype(np.int64)


@pytest.mark.parametrize("record", [True, False])
def test_touched_keys_match_jax(record):
    js, ps = jhs.HostStore(row_capacity=4096), phs.HostStore(row_capacity=4096)
    seen = set()
    for step in range(3):
        fids = np.unique(_fids(step, 300))
        js.map_train(fids, ts=step, record_touch=record)
        ps.map_train(fids, ts=step, record_touch=record)
        seen |= set(fids.tolist())
    # the pending count may hold an id once per step; the drain dedups
    assert ps.touched_size() == js.touched_size()
    assert ps.touched_size() >= len(seen) if record else \
        ps.touched_size() == 0
    first = ps.drain_touched(cap=100)
    assert len(first) == (100 if record else 0)
    rest = ps.drain_touched()
    assert ps.touched_size() == 0 and len(ps.drain_touched()) == 0
    got = set(first.tolist()) | set(rest.tolist())
    assert len(got) == len(first) + len(rest)        # deduplicated
    assert got == (seen if record else set())
    assert set(js.drain_touched().tolist()) == got


@pytest.mark.parametrize("kind", ["SLIDING", "NONE"])
def test_filter_state_crosses_the_packages(kind):
    def make(mod):
        return mod.HostStore(row_capacity=4096,
                             filter_kind=getattr(mod.FilterKind, kind),
                             admit_threshold=3, filter_capacity=1 << 12)
    js, ps = make(jhs), make(phs)
    for step in range(4):
        fids = np.unique(_fids(10 + step, 400, hi=900))
        jr = js.map_train(fids, ts=step)
        pr = ps.map_train(fids, ts=step)
        for a, b in zip(pr, jr):
            np.testing.assert_array_equal(a, b)
    blob = ps.filter_save()
    assert blob == js.filter_save()
    assert (len(blob) > 0) == (kind == "SLIDING")
    # a fresh store of either package takes the other's bytes and then
    # admits exactly as the original does
    js2, ps2 = make(jhs), make(phs)
    for dst, src in ((js2, ps), (ps2, js)):
        dst.restore(*src.save())
        dst.filter_restore(src.filter_save())
    fids = np.unique(_fids(99, 400, hi=900))
    want = ps.map_train(fids, ts=9)
    for other in (js2, ps2):
        for a, b in zip(other.map_train(fids, ts=9), want):
            np.testing.assert_array_equal(a, b)
    if kind == "SLIDING":
        with pytest.raises(ValueError, match="filter_restore failed"):
            ps2.filter_restore(blob[:-8])
    ps2.filter_restore(b"")   # nothing to restore: a no-op


@pytest.mark.parametrize("cap", [64, 4096])
def test_batcher_dedup_matches_jax(cap):
    values = _fids(3, 1000, hi=300)
    values[::11] = -1
    ju, ji, jc, jo = jhs.Batcher(expected_unique=cap).dedup(values, 1, cap)
    pu, pi, pc, po = phs.Batcher(expected_unique=cap).dedup(values, 1, cap)
    assert po == jo and (po > 0) == (cap == 64)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pu[0, :pc[0]], ju[0, :jc[0]])
    np.testing.assert_array_equal(pi, ji)
    assert pu.shape == (1, cap) and pi.dtype == np.int32
    ok = pi >= 0
    np.testing.assert_array_equal(pu[0][pi[ok]], values[ok])
    assert (values[~ok] == -1).sum() == (values == -1).sum()


@pytest.mark.parametrize("shards", [1, 2, 8, 13])
def test_shard_of_matches_jax_and_the_native_hash(shards):
    fids = np.concatenate([_fids(5, 500, hi=1 << 62),
                           np.array([0, 1, -1, (1 << 63) - 1, -(1 << 63)])])
    got = phs.shard_of_batch(fids, shards)
    np.testing.assert_array_equal(got, jhs.shard_of_batch(fids, shards))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < shards
    for f, s in zip(fids[:40].tolist() + fids[-5:].tolist(),
                    got[:40].tolist() + got[-5:].tolist()):
        assert phs.shard_of(f, shards) == s == jhs.shard_of(f, shards)


def test_engine_records_touches_only_when_asked():
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=64, seed=1)
    fb, _ = data.batch()
    task, jtask = DeepFMTask(capacity_per_shard=4096), \
        JaxDeepFMTask(capacity_per_shard=4096)
    touched = {}
    for record in (False, True):
        pe = EmbeddingEngine(task.tables(), task.features(), EngineConfig(
            unique_cap=512, new_cap=512, record_touch=record), device="cpu")
        je = JaxEngine(jtask.tables(), jtask.features(), JaxEngineConfig(
            num_shards=1, unique_cap=512, new_cap=512, record_touch=record))
        pw, _ = pe.prepare_wire(fb, ts=5)
        jw, _ = je.prepare_wire(fb, ts=5)
        np.testing.assert_array_equal(pw, jw)
        touched[record] = (set(pe.stores["sparse"].drain_touched().tolist()),
                           set(je.stores["sparse"][0].drain_touched().tolist()))
    assert touched[False] == (set(), set())
    ids = set(np.concatenate([v.ravel() for v in fb.values()]).tolist()) - {-1}
    assert touched[True] == (ids, ids)

"""Two-tier storage in the port against the JAX package, on the CPU: the
host archive (`embedding/tiered.py`), the engine's host path
(`prepare_batch`, `pack_wire`) with its revives, and a tiered trainer that
trains, spills, trains other ids, revives and trains again from one carried
state; archives in checkpoints both ways; the reference's eval-time revive.

Small shapes (tests/test_tiered.py's: DeepFM dim 8, hidden (8,), capacity
64, unique_cap 256, ttl 3600 s, batches of 4-16 ids), inputs made from a
seed with numpy, `init_scale=0.0` where trainers are compared (the two
packages' init PRNGs differ). Tolerances: archives, stores, rows, masks,
indices, wires and revive positions exact; losses rtol 1e-5; pools and
archived values atol 1e-6 (f32 sums in another order), as
tests/test_torch_trainer.py states them.
"""

import os

import numpy as np
import pytest
import torch

from monolith_tpu.embedding import initializers as jinit
from monolith_tpu.embedding import optimizers as jopt
from monolith_tpu.embedding import tiered as jtiered
from monolith_tpu.embedding.engine import EmbeddingEngine as JaxEngine
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.embedding.spec import TableSegment as JaxSegment
from monolith_tpu.embedding.spec import TableSpec as JaxTableSpec
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import Trainer as JaxTrainer
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.embedding import initializers as pinit
from monolith_tpu_torch.embedding import optimizers as popt
from monolith_tpu_torch.embedding import tiered as ptiered
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

TASK = dict(embedding_dim=8, capacity_per_shard=64, hidden=(8,),
            ttl_seconds=3600, init_scale=0.0)
U = 256


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def ids_batch(ids, label=1.0, items=100):
    """A DeepFM batch of the given user ids (items = ids + `items`), no
    history: tests/test_tiered.py's shape."""
    ids = np.asarray(ids, np.int64)[:, None]
    return ({"user_id": ids, "item_id": ids + items,
             "hist_items": np.full((len(ids), 10), -1, np.int64)},
            {"label": np.full(len(ids), label, np.float32)})


def twins(tiered=True, capacity=64, seed=3, **engine):
    """A JAX trainer and a port trainer from one carried state, both with
    empty host stores."""
    jt = JaxTrainer(JaxDeepFMTask(**{**TASK, "capacity_per_shard": capacity}),
                    JaxTrainerConfig(engine=JaxEngineConfig(
                        num_shards=1, unique_cap=U, new_cap=U, tiered=tiered,
                        **engine), log_every=0, seed=seed))
    fb, b = ids_batch([10 ** 9])
    inputs, _ = jt.engine.prepare_batch(fb, ts=0)
    jt._maybe_init(inputs, b)       # the JAX trainer builds its params here
    jt.engine.stores["sparse"][0].restore(np.empty(0, np.int64),
                                          np.empty(0, np.int32))
    pt = Trainer(DeepFMTask(**{**TASK, "capacity_per_shard": capacity}),
                 convert.port_trainer_config(jt.config), device="cpu")
    convert.load_state(pt, convert.jax_trainer_state(jt))
    return jt, pt


def step_both(jt, pt, pair, ts):
    lj = float(jt.train_step(*pair, ts=ts)["loss"])
    lp = float(pt.train_step(*pair, ts=ts)["loss"])
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    return lp


def assert_tables_equal(jt, pt, atol=1e-6):
    """Stores exact; pools (every row: the row assignment is the same C++
    on the same calls) within atol."""
    js, ps = convert.jax_trainer_state(jt), convert.export_state(pt)
    for t in js["stores"]:
        a, b = js["stores"][t], ps["stores"][t]
        oa, ob = np.argsort(a[0]), np.argsort(b[0])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[oa], y[ob])
        np.testing.assert_allclose(ps["tables"][t].reshape(-1, 128),
                                   js["tables"][t].reshape(-1, 128),
                                   atol=atol)


def assert_archives_equal(ja, pa, atol=1e-6):
    """Archives in convert.jax_archives' format: entries, archive rows,
    timestamps and counters exact; values within atol."""
    assert set(ja) == set(pa)
    for t in ja:
        a, b = ja[t], pa[t]
        oa, ob = np.argsort(a["fids"]), np.argsort(b["fids"])
        for k in ("fids", "rows", "map_tss", "tss"):
            np.testing.assert_array_equal(a[k][oa], b[k][ob])
        np.testing.assert_allclose(b["values"][ob], a["values"][oa],
                                   atol=atol)
        for k in ("spilled", "revived", "dropped"):
            assert a[k] == b[k], (t, k, a[k], b[k])


def both_archives_equal(jt, pt, atol=1e-6):
    assert_archives_equal(convert.jax_archives(jt), convert.export_archives(pt),
                          atol)


def adagrad_spec(pkg, capacity=16, dim=4):
    seg, spec, opt, init = ((JaxSegment, JaxTableSpec, jopt, jinit)
                            if pkg == "jax" else
                            (TableSegment, TableSpec, popt, pinit))
    return spec("t", capacity, (seg(
        dim=dim, optimizer=opt.Adagrad(learning_rate=0.1),
        initializer=init.Zeros()),))


# ----------------------------------------------------------------------
# the archive and its row format
# ----------------------------------------------------------------------

def test_archive_spill_revive_round_trip_matches_jax():
    ja = jtiered.RowArchive(adagrad_spec("jax"), capacity=32)
    pa = ptiered.RowArchive(adagrad_spec("port"), capacity=32)
    assert ja.width == pa.width == 8          # 4 params + 4 Adagrad slots
    vals = np.arange(16, dtype=np.float32).reshape(2, 8)
    fids = np.array([10, 20], np.int64)
    assert ja.spill(fids, vals, ts=1) == pa.spill(fids, vals, ts=1) == 2
    for probe in ([20, 99], [20], [10, 10, 5]):
        jok, jv = ja.revive(np.array(probe, np.int64))
        pok, pv = pa.revive(np.array(probe, np.int64))
        np.testing.assert_array_equal(pok, jok)
        np.testing.assert_array_equal(pv, jv)
        assert pa.size() == ja.size()
    assert (pa.spilled, pa.revived, pa.dropped) == \
        (ja.spilled, ja.revived, ja.dropped) == (2, 3, 0)


@pytest.mark.parametrize("capacity,waves", [(4, 3), (8, 5)])
def test_archive_recycles_the_oldest_like_jax(capacity, waves):
    """Spills beyond capacity recycle the oldest entries; the same calls
    give the same entries, rows, values and counters."""
    rng = np.random.default_rng(capacity)
    ja = jtiered.RowArchive(adagrad_spec("jax"), capacity=capacity)
    pa = ptiered.RowArchive(adagrad_spec("port"), capacity=capacity)
    for w in range(waves):
        fids = rng.choice(40, size=3, replace=False).astype(np.int64)
        vals = rng.normal(size=(3, 8)).astype(np.float32)
        assert ja.spill(fids, vals, ts=100 + w) == \
            pa.spill(fids, vals, ts=100 + w)
        probe = rng.choice(40, size=2, replace=False).astype(np.int64)
        jok, jv = ja.revive(probe)
        pok, pv = pa.revive(probe)
        np.testing.assert_array_equal(pok, jok)
        np.testing.assert_array_equal(pv, jv)
    assert_archives_equal({"t": convert._archive_state(ja)},
                          {"t": convert._archive_state(pa)}, atol=0)
    # the oldest was dropped, the newest is there
    pa.spill(np.array([99], np.int64), np.full((1, 8), 9, np.float32),
             ts=10 ** 6)
    ok, v = pa.revive(np.array([99], np.int64))
    assert ok[0] and v[0, 0] == 9


def test_state_width_pack_rows_and_split_match_jax():
    jspec, pspec = adagrad_spec("jax", 32, 6), adagrad_spec("port", 32, 6)
    assert ptiered.state_width(pspec) == jtiered.state_width(jspec) == 12
    deepfm = (JaxDeepFMTask(**TASK).tables()[0], DeepFMTask(**TASK).tables()[0])
    assert ptiered.state_width(deepfm[1]) == jtiered.state_width(deepfm[0]) \
        == 1 + 8 + 8        # params + the vector segment's Adagrad slot
    pool = np.random.default_rng(0).normal(size=(32, 128)).astype(np.float32)
    rows = np.array([3, 0, 31, 7], np.int32)
    got = ptiered.pack_rows(pspec, {"data": torch.from_numpy(pool)}, rows)
    want = jtiered.pack_rows(jspec, {"data": pool}, rows)
    np.testing.assert_array_equal(got, want)
    (pp, ps), (jp, js) = (ptiered.split_row_values(pspec, got),
                          jtiered.split_row_values(jspec, want))
    np.testing.assert_array_equal(pp, jp)
    assert [sorted(d) for d in ps] == [sorted(d) for d in js]
    for a, b in zip(ps, js):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------------------------
# the engine's host path
# ----------------------------------------------------------------------

def twin_engines(threshold, tiered=True, record_touch=False):
    kw = dict(embedding_dim=4, capacity_per_shard=48,
              admission_threshold=threshold, ttl_seconds=10)
    jtask, ptask = JaxDeepFMTask(**kw), DeepFMTask(**kw)
    je = JaxEngine(jtask.tables(), jtask.features(), JaxEngineConfig(
        num_shards=1, unique_cap=64, new_cap=16, tiered=tiered,
        record_touch=record_touch), seed=4)
    pe = EmbeddingEngine(ptask.tables(), ptask.features(), EngineConfig(
        unique_cap=64, new_cap=16, tiered=tiered, record_touch=record_touch),
        seed=4, device="cpu")
    return je, pe


def random_fids(rng, B=6):
    return {"user_id": rng.integers(-1, 30, (B, 1)).astype(np.int64),
            "item_id": rng.integers(20, 50, (B, 1)).astype(np.int64),
            "hist_items": rng.integers(-1, 50, (B, 10)).astype(np.int64)}


@pytest.mark.parametrize("threshold", [1, 2])
def test_prepare_batch_matches_jax_with_revives(threshold):
    """Twin engines: every step's rows, new_mask, index and stats equal
    JAX's; every few steps the same expired ids spill into both archives,
    so later steps revive them: the first n revive entries equal JAX's, the
    rest of the port's power-of-two array is -1."""
    je, pe = twin_engines(threshold)
    width = ptiered.state_width(pe.tables["sparse"])
    rng = np.random.default_rng(threshold)
    revived = 0
    for step in range(12):
        fb = random_fids(rng)
        jin, js = je.prepare_batch(fb, ts=step * 4)
        pin, ps = pe.prepare_batch(fb, ts=step * 4)
        j, p = jin["sparse"], pin["sparse"]
        np.testing.assert_array_equal(p["rows"], j["rows"][0])
        np.testing.assert_array_equal(p["new_mask"], j["new_mask"][0])
        for f in j["index"]:
            np.testing.assert_array_equal(p["index"][f],
                                          j["index"][f].astype(np.int32))
        assert ps == js
        n = int((j["revive_pos"][0] >= 0).sum())
        m = len(p["revive_pos"])
        assert m == (0 if n == 0 else 1 << (n - 1).bit_length())
        np.testing.assert_array_equal(p["revive_pos"][:n],
                                      j["revive_pos"][0, :n])
        assert (p["revive_pos"][n:] == -1).all()
        np.testing.assert_array_equal(p["revive_values"][:n],
                                      j["revive_values"][0, :n])
        assert p["revive_values"].shape == (m, width)
        revived += n
        if step % 3 == 2:
            jr, jf = je.stores["sparse"][0].evict_expired(step * 4 - 6,
                                                          return_fids=True)
            pr, pf = pe.stores["sparse"].evict_expired(step * 4 - 6,
                                                      return_fids=True)
            np.testing.assert_array_equal(pr, jr)
            np.testing.assert_array_equal(pf, jf)
            vals = (pf[:, None] * 0.5 + np.arange(width)).astype(np.float32)
            je.archives["sparse"][0].spill(jf, vals, ts=step)
            pe.archives["sparse"].spill(pf, vals, ts=step)
    assert revived > 0
    assert pe.archives["sparse"].revived == je.archives["sparse"][0].revived \
        == revived


@pytest.mark.parametrize("threshold,record_touch", [(1, False), (2, True)])
def test_pack_wire_of_prepare_batch_is_prepare_wire(threshold, record_touch):
    """pack_wire(prepare_batch(...)) equals, byte for byte, the wire that
    prepare_wire writes on a twin engine and JAX's pack_wire on JAX's
    prepare_batch; the stats agree too."""
    _, a = twin_engines(threshold, tiered=False, record_touch=record_touch)
    je, b = twin_engines(threshold, tiered=False, record_touch=record_touch)
    rng = np.random.default_rng(9)
    for step in range(6):
        fb = random_fids(rng, B=16)
        inputs, sa = a.prepare_batch(fb, ts=step)
        wire = a.pack_wire(inputs)
        ref, sb = b.prepare_wire(fb, ts=step)
        np.testing.assert_array_equal(wire, ref)
        assert wire.dtype == np.int32 and wire.size == a.wire_words(16)
        jin, _ = je.prepare_batch(fb, ts=step)
        np.testing.assert_array_equal(wire, je.pack_wire(jin))
        assert sa == sb
    if record_touch:
        np.testing.assert_array_equal(
            np.sort(a.stores["sparse"].drain_touched()),
            np.sort(b.stores["sparse"].drain_touched()))


# ----------------------------------------------------------------------
# the tiered trainer against JAX's
# ----------------------------------------------------------------------

def test_tiered_train_spill_revive_train_matches_jax():
    """train -> spill -> other ids take the freed rows -> the spilled ids
    revive with their exact state -> train: losses, pools, stores and
    archives equal JAX's at every stage."""
    jt, pt = twins()
    fb = ids_batch(np.arange(1, 9))
    for i in range(3):
        step_both(jt, pt, fb, ts=100)
    assert_tables_equal(jt, pt)
    spec = pt.engine.tables["sparse"]
    rows = pt.engine.stores["sparse"].lookup(fb[0]["user_id"].ravel())
    before = ptiered.pack_rows(spec, pt.table_states["sparse"], rows)

    assert pt.spill_expired(200) == jt.spill_expired(200) == {"sparse": 16}
    assert pt.engine.stores["sparse"].size() == 0
    assert pt.engine.archives["sparse"].size() == 16
    # what was archived is what the pool held before the spill
    arch = convert.export_archives(pt)["sparse"]
    got = dict(zip(arch["fids"].tolist(), arch["values"]))
    for fid, row in zip(fb[0]["user_id"].ravel().tolist(), before):
        np.testing.assert_array_equal(got[fid], row)
    both_archives_equal(jt, pt)
    assert_tables_equal(jt, pt)
    assert not pt.table_states["sparse"]["data"][
        torch.from_numpy(rows).long()].any()        # freed rows zeroed

    step_both(jt, pt, ids_batch(np.arange(1000, 1008)), ts=300)
    assert_tables_equal(jt, pt)
    step_both(jt, pt, fb, ts=400)                    # the revive
    assert pt.engine.archives["sparse"].revived == 16
    assert pt.engine.archives["sparse"].size() == 0
    both_archives_equal(jt, pt)
    assert_tables_equal(jt, pt)
    step_both(jt, pt, fb, ts=500)
    assert_tables_equal(jt, pt)


def test_revive_hands_the_model_the_archived_rows():
    """In the step that revives an id, the packed row fused_lookup hands
    the model is the archived state, bit for bit."""
    _, pt = twins()
    fb = ids_batch(np.arange(1, 5))
    for _ in range(3):
        pt.train_step(*fb, ts=100)
    spec = pt.engine.tables["sparse"]
    rows = pt.engine.stores["sparse"].save()[1]
    fids = pt.engine.stores["sparse"].save()[0]
    before = dict(zip(fids.tolist(), ptiered.pack_rows(
        spec, pt.table_states["sparse"], rows)))
    pt.spill_expired(200)
    pt.train_step(*ids_batch(np.arange(1000, 1004)), ts=300)
    seen = {}
    lookup = pt.engine.fused_lookup

    def spy(states, inputs, seed, step):
        prows, unique = lookup(states, inputs, seed, step)
        seen["prows"], seen["rows"] = prows["sparse"], inputs["sparse"]["rows"]
        seen["pos"] = inputs["sparse"]["revive_pos"]
        return prows, unique

    pt.engine.fused_lookup = spy
    pt.train_step(*fb, ts=400)
    pos = seen["pos"][seen["pos"] >= 0].long()
    assert len(pos) == 8
    store_rows = pt.engine.stores["sparse"].lookup(np.array(sorted(before)))
    by_row = dict(zip(store_rows.tolist(), sorted(before)))
    for i in pos.tolist():
        fid = by_row[int(seen["rows"][i])]
        np.testing.assert_array_equal(
            seen["prows"][i, :17].numpy(), before[fid])
        assert not seen["prows"][i, 17:].any()


def test_working_set_larger_than_the_pool_matches_jax():
    """A pool of 64 rows and 96 ids in six waves, a spill after each: no id
    is lost, and the archives, pools and losses equal JAX's."""
    jt, pt = twins(capacity=64)
    for wave in range(6):
        pair = ids_batch(np.arange(8) + wave * 50, items=10_000)
        for _ in range(3):
            step_both(jt, pt, pair, ts=wave * 100)
        assert pt.spill_expired(wave * 100 + 1) == \
            jt.spill_expired(wave * 100 + 1)
    assert pt.engine.archives["sparse"].size() == 6 * 16
    both_archives_equal(jt, pt)
    assert_tables_equal(jt, pt)


def test_tiered_trainer_steps_one_by_one():
    """As in the JAX package (fuse_wire is off when tiered): train() with
    steps_per_dispatch > 1 takes single steps, and a block is refused."""
    _, pt = twins()
    pt.config.steps_per_dispatch = 4
    blocks = []
    block = pt.train_step_block
    pt.train_step_block = lambda *a, **k: blocks.append(1) or block(*a, **k)
    data = iter([ids_batch(np.arange(i, i + 4)) for i in range(1, 7)])
    pt.train(data, steps=6)
    assert pt.step == 6 and not blocks
    assert not pt._block_capable()
    with pytest.raises(ValueError, match="steps one by one"):
        pt.stage_block([ids_batch([1]), ids_batch([2])], ts=1)


def test_spill_requires_a_tiered_engine():
    _, pt = twins(tiered=False)
    with pytest.raises(ValueError, match="tiered=True"):
        pt.spill_expired(1)


def test_port_trainer_config_carries_tiered():
    cfg = convert.port_trainer_config(JaxTrainerConfig(engine=JaxEngineConfig(
        num_shards=1, tiered=True, archive_capacity=77)))
    assert cfg.engine.tiered and cfg.engine.archive_capacity == 77
    tr = Trainer(DeepFMTask(**TASK), cfg, device="cpu")
    assert tr.engine.archives["sparse"].capacity == 77
    assert Trainer(DeepFMTask(**TASK), TrainerConfig(engine=EngineConfig(
        tiered=True)), device="cpu").engine.archives["sparse"].capacity == 256


def test_archives_carry_across_packages_both_ways():
    """convert.jax_archives / load_archives give the other package's
    archive the same entries, rows, values, timestamps and counters, and
    both then revive the same."""
    jt, pt = twins()
    for _ in range(2):
        step_both(jt, pt, ids_batch(np.arange(1, 7)), ts=100)
    jt.spill_expired(200)
    convert.load_archives(pt.engine.archives, convert.jax_archives(jt))
    both_archives_equal(jt, pt, atol=0)
    j2, _ = twins()
    convert.load_archives({t: a[0] for t, a in j2.engine.archives.items()},
                          convert.export_archives(pt))
    assert_archives_equal(convert.jax_archives(j2),
                          convert.export_archives(pt), atol=0)
    probe = np.array([1, 2, 3, 999], np.int64)
    jok, jv = j2.engine.archives["sparse"][0].revive(probe)
    pok, pv = pt.engine.archives["sparse"].revive(probe)
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(pv, jv)


# ----------------------------------------------------------------------
# archives in checkpoints
# ----------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archives_survive_a_checkpoint_across_packages(tmp_path, writer):
    """A tiered checkpoint written by either package restores its archive
    in the other (archives/sparse-s0.npz, JAX's keys); the restored archive
    revives the exact pre-spill state."""
    jt, pt = twins()
    fb = ids_batch(np.arange(1, 5))
    for _ in range(3):
        step_both(jt, pt, fb, ts=100)
    spec = pt.engine.tables["sparse"]
    rows = pt.engine.stores["sparse"].lookup(fb[0]["user_id"].ravel())
    before = ptiered.pack_rows(spec, pt.table_states["sparse"], rows)
    jt.spill_expired(200)
    pt.spill_expired(200)
    if writer == "jax":
        path = jckpt.save(jt, str(tmp_path))
        _, reader = twins()
        pckpt.restore(reader, str(tmp_path))
        got = reader.engine.archives["sparse"]
    else:
        path = pckpt.save(pt, str(tmp_path))
        reader, _ = twins()
        jckpt.restore(reader, str(tmp_path))
        got = reader.engine.archives["sparse"][0]
    z = np.load(os.path.join(path, "archives", "sparse-s0.npz"))
    assert sorted(z.files) == ["fids", "rows", "tss", "values"]
    assert got.size() == 8
    ok, vals = got.revive(fb[0]["user_id"].ravel())
    assert ok.all()
    np.testing.assert_allclose(vals, before, atol=1e-6)


def test_restored_archive_equals_the_saved_one(tmp_path):
    _, pt = twins()
    for _ in range(2):
        pt.train_step(*ids_batch(np.arange(1, 9)), ts=100)
    pt.spill_expired(200)
    pckpt.save(pt, str(tmp_path))
    _, other = twins()
    pckpt.restore(other, str(tmp_path))
    a, b = (convert.export_archives(t)["sparse"] for t in (pt, other))
    # by fid: a restore assigns the archive's rows afresh, as JAX's does
    oa, ob = np.argsort(a["fids"]), np.argsort(b["fids"])
    for k in ("fids", "tss", "values"):
        np.testing.assert_array_equal(b[k][ob], a[k][oa])


def test_a_sharded_jax_checkpoints_archive_restores_shard_0(tmp_path):
    """A JAX checkpoint of 2 shards: the port restores archives/<t>-s0.npz
    only, as a one-shard JAX trainer does."""
    _, pt = twins()
    for _ in range(2):
        pt.train_step(*ids_batch(np.arange(1, 9)), ts=100)
    pt.spill_expired(200)
    path = pckpt.save(pt, str(tmp_path))
    s0 = os.path.join(path, "archives", "sparse-s0.npz")
    z = dict(np.load(s0))
    half = len(z["fids"]) // 2
    np.savez(s0, **{k: v[:half] for k, v in z.items()})
    np.savez(os.path.join(path, "archives", "sparse-s1.npz"),
             **{k: v[half:] for k, v in z.items()})
    _, reader = twins()
    pckpt.restore(reader, str(tmp_path))
    jr, _ = twins()
    jckpt.restore(jr, str(tmp_path))
    assert reader.engine.archives["sparse"].size() == \
        jr.engine.archives["sparse"][0].size() == half
    np.testing.assert_array_equal(
        np.sort(reader.engine.archives["sparse"].map.save()[0]),
        np.sort(z["fids"][:half]))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_non_tiered_checkpoint_writes_no_archives(tmp_path, pkg):
    jt, pt = twins(tiered=False)
    tr = jt if pkg == "jax" else pt
    tr.train_step(*ids_batch(np.arange(1, 5)), ts=100)
    path = (jckpt if pkg == "jax" else pckpt).save(tr, str(tmp_path))
    assert not os.path.isdir(os.path.join(path, "archives"))
    _, reader = twins(tiered=False)
    assert pckpt.restore(reader, str(tmp_path)) == 1


# ----------------------------------------------------------------------
# the reference's eval-time revive, copied
# ----------------------------------------------------------------------

def test_evaluate_revives_into_nothing_as_the_reference_does():
    """A tiered trainer's evaluate prepares at ts=0 through prepare_batch:
    it admits the eval batch's unseen ids and takes spilled ids out of the
    archive (counted as revived), but the forward only looks rows up, so
    the revived state never reaches the pool. Both packages do exactly
    that: archives, stores and pools equal after the eval."""
    jt, pt = twins()
    fb, b = ids_batch(np.arange(1, 7))
    for _ in range(2):
        step_both(jt, pt, (fb, b), ts=100)
    jt.spill_expired(200)
    pt.spill_expired(200)
    eval_pair = ids_batch(np.arange(1, 7), label=0.0)
    eval_pair[1]["label"][:3] = 1.0
    rj = jt.evaluate(iter([eval_pair]))
    rp = pt.evaluate(iter([eval_pair]))
    np.testing.assert_allclose(rp["loss"], rj["loss"], rtol=1e-5)
    assert rp["auc"] == rj["auc"]
    arch = pt.engine.archives["sparse"]
    assert arch.size() == 0 and arch.revived == 12
    both_archives_equal(jt, pt)
    assert_tables_equal(jt, pt)
    # the revived ids hold zero rows, admitted at ts 0
    fids, rows, tss, _ = pt.engine.stores["sparse"].save()
    assert len(fids) == 12 and (tss == 0).all()
    assert not pt.table_states["sparse"]["data"][
        torch.from_numpy(rows).long()].any()

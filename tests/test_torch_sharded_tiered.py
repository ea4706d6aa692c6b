"""Tiered storage and deltas on the port's ShardedTrainer over 2 and 4
gloo ranks on the CPU, against the JAX package's tiered ShardedTrainer on
2 and 4 virtual CPU devices (tests/test_tiered.py's sharded sequence).

Each (S, exchange) scenario starts once (cached for the module): the JAX
trainer (tiered, ttl, init_scale=0.0) takes two steps and spills the ids
of the first, and its state, with every shard's pool and host store and
shard r's archive, is carried by `convert.py` to S rank processes
(tests/torch_sharded_tiered_worker.py), which run the port's trainers
while the JAX trainer runs the same batches here: steps that revive the
spilled ids, a spill, steps that revive again. Then:

- losses, the global predictions, every shard's pool, the dense state,
  each rank's archive (fids, rows, timestamps, values, counters) within
  rtol 1e-5 / atol 1e-6 of JAX's shard (values) or exactly (the rest);
  stats, the stores and the spilled and revived counts exactly;
- within the port: every revived row handed to the model equals its
  archived state bit for bit; a block that revives equals its steps bit
  for bit; the stores are equal on every rank;
- the archive survives a checkpoint (S = 2);
- deltas: the ranks write JAX's per-shard layout; a JAX sharded delta
  restores into the port ranks and a port one into JAX, equal by id; a
  delta of another shard count and a multi-host trainer's delta are
  refused with a named error, and the two faults of the JAX package behind
  those refusals (R7, R8 in ROADMAP §3) are pinned.

The engine's tiered prepares at S > 1 are held array for array against
the JAX engine in process.
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.embedding.engine import EmbeddingEngine as JaxEngine
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from monolith_tpu.parallel import make_mesh as jax_make_mesh
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.embedding.host_store import shard_of_batch
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

from torch_sharded_worker import start_ranks, wait_ranks

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_sharded_tiered_worker.py")
TASK = dict(embedding_dim=8, capacity_per_shard=1024, hidden=(16,),
            init_scale=0.0, ttl_seconds=10)
ENGINE = dict(unique_cap=128, new_cap=128, tiered=True)
SEED, B, STEPS = 13, 64, 3
TS0 = 2            # the revive steps' first ts (the carried steps ran at 0, 1)
SPILL_BEFORE = 4   # spills the ids last touched at ts <= 3
POST_TS = 5
RTOL, ATOL = 1e-5, 1e-6
SCENARIOS = [(2, "allgather"), (2, "a2a"), (4, "allgather"), (4, "a2a")]
IDS = [f"S{s}-{e}" for s, e in SCENARIOS]


def jax_trainer(S, exchange):
    cfg = JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=S, exchange=exchange, **ENGINE),
        log_every=0, seed=SEED)
    return JaxShardedTrainer(JaxDeepFMTask(**TASK), cfg, jax_make_mesh(S))


def _jax_snapshot(jt, S):
    st = convert.jax_trainer_state(jt)
    return {"pools": st["tables"], "stores": st["stores"],
            "params": st["params"], "opt_state": st["opt_state"],
            "archives": [convert.jax_archives(jt, s) for s in range(S)]}


@functools.lru_cache(maxsize=None)
def scenario(S, exchange):
    """(JAX results, every rank's results) of one scenario."""
    work = tempfile.mkdtemp(prefix=f"torch_sharded_tiered_S{S}{exchange}_")
    data = JaxSyntheticCTR(num_users=60, num_items=40, batch_size=B,
                           seed=SEED)
    pair0, pair1 = data.batch(), data.batch()
    pairs = [data.batch() for _ in range(STEPS)]
    post = [data.batch() for _ in range(STEPS)]
    jt = jax_trainer(S, exchange)
    jt.train_step(*pair0, ts=0)
    jt.train_step(*pair1, ts=1)
    # the JAX delta of the second step's ids, for the ranks to restore
    jax_delta = jckpt.save_delta(jt, os.path.join(work, "jax_delta"),
                                 since_ts=1)
    spilled0 = jt.spill_expired(1)
    # a single-shard delta, which a sharded trainer must refuse
    single = Trainer(DeepFMTask(**TASK), TrainerConfig(
        engine=EngineConfig(**ENGINE), seed=SEED), device="cpu")
    single.train_step(*pair0, ts=0)
    single_delta = pckpt.save_delta(single, os.path.join(work, "single"),
                                    since_ts=0)
    state0 = convert.jax_trainer_state(jt)
    archives0 = [convert.jax_archives(jt, r) for r in range(S)]
    # JAX reloads its own stores and archives from what it carries, so
    # that both sides hold the free lists a restore builds
    for r in range(S):
        jt.engine.stores["sparse"][r].restore(*state0["stores"]["sparse"][r])
        convert.load_archives({"sparse": jt.engine.archives["sparse"][r]},
                              archives0[r])
    job = {"task": TASK, "engine": dict(ENGINE, num_shards=S,
                                        exchange=exchange),
           "seed": SEED, "state0": state0, "archives0": archives0,
           "pairs": pairs, "post": post, "ts0": TS0,
           "spill_before": SPILL_BEFORE, "post_ts": POST_TS,
           "jax_delta": jax_delta, "single_delta": single_delta,
           "port_delta_dir": os.path.join(work, "port_delta"),
           "ckpt_dir": os.path.join(work, "ckpt") if S == 2 else None}
    handle = start_ranks(S, job, WORKER)   # the ranks run while JAX runs
    try:
        ref = {"spilled0": spilled0, "steps": [], "post": [],
               "jax_delta": jax_delta}
        for i, pair in enumerate(pairs):
            out = jt.train_step(*pair, ts=TS0 + i)
            ref["steps"].append({"loss": float(out["loss"]),
                                 "preds": np.asarray(out["preds"]),
                                 "stats": out["stats"]})
        ref["revived_steps"] = [a.revived for a in
                                jt.engine.archives["sparse"]]
        ref["after_steps"] = _jax_snapshot(jt, S)
        ref["spilled"] = jt.spill_expired(SPILL_BEFORE)
        ref["after_spill"] = _jax_snapshot(jt, S)
        for i, pair in enumerate(post):
            out = jt.train_step(*pair, ts=POST_TS + i)
            ref["post"].append({"loss": float(out["loss"]),
                                "preds": np.asarray(out["preds"]),
                                "stats": out["stats"]})
        ref["revived"] = [a.revived for a in jt.engine.archives["sparse"]]
        ref["after_post"] = _jax_snapshot(jt, S)
    except BaseException:
        try:       # stop the ranks; the JAX side's error is the one to see
            wait_ranks(handle, timeout=1)
        except AssertionError:
            pass
        raise
    ranks = wait_ranks(handle)
    # the ranks' delta restored into the JAX trainer
    port_delta = ranks[0]["port_delta"]
    ref["port_delta_applied"] = jckpt.restore_delta(jt, port_delta)
    ref["port_delta_rows"] = [_jax_rows_by_id(jt, s, np.load(os.path.join(
        port_delta, f"sparse-s{s}.npz"))["fids"]) for s in range(S)]
    if S == 2:
        ref["r8"] = _pin_r8(jt, single_delta)
        ref["r7"] = _pin_r7(jt, os.path.join(work, "r7"))
    return ref, ranks


def _jax_rows_by_id(jt, shard, fids):
    """JAX's params of `fids` in shard `shard` (NaN where absent)."""
    st = convert.jax_trainer_state(jt)
    rows = jt.engine.stores["sparse"][shard].lookup(np.asarray(fids))
    pool = st["tables"]["sparse"][shard]
    out = np.full((len(fids), jt.engine.tables["sparse"].dim), np.nan,
                  np.float32)
    out[rows >= 0] = pool[rows[rows >= 0], :out.shape[1]]
    return out


def _pin_r8(jt, single_delta):
    """R8: the JAX restore_delta puts shard k's ids into store k whatever
    the counts: a one-shard delta lands whole in store 0 of a two-shard
    trainer, ids that shard 1 owns included."""
    fids = np.load(os.path.join(single_delta, "sparse-s0.npz"))["fids"]
    jckpt.restore_delta(jt, single_delta)
    in0 = jt.engine.stores["sparse"][0].lookup(fids) >= 0
    owned_by_1 = shard_of_batch(fids, 2) == 1
    return {"misplaced": int((in0 & owned_by_1).sum()),
            "owned_by_1": int(owned_by_1.sum())}


def _pin_r7(jt, path):
    """R7: the JAX save_delta reads every shard's store, and a process of
    a multi-process trainer holds None for the others' (as a multi-process
    MultiHostTrainer's engine does)."""
    jt.engine.stores["sparse"][1] = None
    try:
        jckpt.save_delta(jt, path, since_ts=0)
    except AttributeError as e:
        return str(e)
    return None


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def close_tree(a, b, what):
    fa, fb = convert._flatten(a), convert._flatten(b)
    assert set(fa) == set(fb), what
    for k in fa:
        close(fa[k], fb[k], f"{what} {k}")


def equal_tree(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            equal_tree(a[k], b[k], f"{what} {k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            equal_tree(x, y, f"{what} {i}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def check_archive(got, want, what):
    """An archive in jax_archives' format: values within tolerance, the
    rest exactly."""
    assert set(got) == set(want), what
    for k in want:
        if k == "values":
            close(got[k], want[k], f"{what} values")
        else:
            np.testing.assert_array_equal(got[k], want[k], f"{what} {k}")


def check_state(ranks, key, ref, what):
    """Every rank's pool and archive against JAX's shard, every store it
    holds exactly, the dense state against JAX's."""
    for r, res in enumerate(ranks):
        snap = res[key]
        for t, pool in snap["pool"].items():
            close(pool, ref["pools"][t][r], f"{what}: shard {r} of {t}")
            equal_tree(list(snap["stores"][t]), list(ref["stores"][t]),
                       f"{what}: stores of {t} on rank {r}")
            check_archive(snap["archives"][t], ref["archives"][r][t],
                          f"{what}: archive {r} of {t}")
        close_tree(snap["params"], ref["params"], f"{what}: params")
        close_tree(snap["opt_state"], ref["opt_state"], f"{what}: opt_state")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_steps_that_revive_match_jax(S, exchange):
    """The carried archives revive on both sides alike."""
    ref, ranks = scenario(S, exchange)
    assert sum(ref["spilled0"].values()) > 0
    assert sum(ref["revived_steps"]) > 0
    for r, res in enumerate(ranks):
        assert res["revived_steps"] == ref["revived_steps"][r]
        for i, (p, j) in enumerate(zip(res["steps"], ref["steps"])):
            close(p["loss"], j["loss"], f"rank {r} step {i} loss")
            assert p["preds"].shape == (B,)
            close(p["preds"], j["preds"], f"rank {r} step {i} preds")
            assert p["stats"] == j["stats"], (r, i)
    check_state(ranks, "after_steps", ref["after_steps"], "after the steps")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_spill_matches_jax(S, exchange):
    """Every rank evicts every shard's expired ids and spills its own;
    each returns the JAX trainer's total."""
    ref, ranks = scenario(S, exchange)
    assert sum(ref["spilled"].values()) > 0
    for res in ranks:
        assert res["spilled"] == ref["spilled"]
    check_state(ranks, "after_spill", ref["after_spill"], "after the spill")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_revive_after_the_spill_matches_jax(S, exchange):
    ref, ranks = scenario(S, exchange)
    assert sum(ref["revived"]) > sum(ref["revived_steps"])
    for r, res in enumerate(ranks):
        assert res["revived"] == ref["revived"][r]
        for i, (p, j) in enumerate(zip(res["post"], ref["post"])):
            close(p["loss"], j["loss"], f"rank {r} step {i} loss")
            close(p["preds"], j["preds"], f"rank {r} step {i} preds")
            assert p["stats"] == j["stats"], (r, i)
    check_state(ranks, "after_post", ref["after_post"], "after the revive")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_revived_rows_are_their_archived_state(S, exchange):
    """Each revived row the model reads is the archive's row bit for bit
    (checked at every step in the rank); every rank revived what its
    archive counted."""
    ref, ranks = scenario(S, exchange)
    for r, res in enumerate(ranks):
        assert res["revived_seen"] == res["revived"] == ref["revived"][r]
        assert res["revived_from_archive"]


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_block_that_revives_equals_its_steps(S, exchange):
    _, ranks = scenario(S, exchange)
    for r, res in enumerate(ranks):
        b, s = res["twins"]["block"], res["twins"]["steps"]
        assert b["revived"] == s["revived"] == res["revived"]
        np.testing.assert_array_equal(b["losses"], s["losses"])
        for k in ("pool", "archives", "params", "opt_state"):
            equal_tree(b[k], s[k], f"rank {r} {k}")


def test_checkpoint_keeps_the_archives():
    """S = 2: each rank saves its own archive and restores it."""
    _, ranks = scenario(2, "allgather")
    assert ranks[0]["archive_files"] == ["sparse-s0.npz", "sparse-s1.npz"]
    for r, res in enumerate(ranks):
        assert sum(res["spilled_before_ckpt"].values()) > 0
        got, want = res["restored"], res["before_ckpt"]
        assert len(want["archives"]["sparse"]["fids"]) > 0
        for k in ("fids", "values"):
            order = np.argsort(want["archives"]["sparse"]["fids"])
            gorder = np.argsort(got["archives"]["sparse"]["fids"])
            np.testing.assert_array_equal(
                got["archives"]["sparse"][k][gorder],
                want["archives"]["sparse"][k][order], f"rank {r} {k}")
        equal_tree(got["stores"], want["stores"], f"rank {r} stores")
        # the live rows (a free row's slots come back at their init value)
        rows = want["stores"]["sparse"][r][1]
        np.testing.assert_array_equal(got["pool"]["sparse"][rows],
                                      want["pool"]["sparse"][rows])


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_sharded_delta_writes_a_file_a_shard(S, exchange):
    """save_delta on a ShardedTrainer (a KeyError before: it read the
    single-shard view of the stores) writes JAX's layout: one
    `sparse-s<k>.npz` a shard from rank k, meta.json with the count."""
    _, ranks = scenario(S, exchange)
    path = ranks[0]["port_delta"]
    assert all(res["port_delta"] == path for res in ranks)
    assert sorted(os.listdir(path)) == ["meta.json"] + [
        f"sparse-s{s}.npz" for s in range(S)]
    import json
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["tables"]["sparse"]["shards"] == S
    for s in range(S):
        z = np.load(os.path.join(path, f"sparse-s{s}.npz"))
        assert sorted(z.files) == ["counts", "fids", "tss", "values"]
        assert (shard_of_batch(z["fids"], S) == s).all()
        assert (z["tss"] >= POST_TS).all()


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_deltas_cross_between_the_packages(S, exchange):
    """A JAX sharded delta restores into the port ranks (every shard file
    into every rank's stores, shard r's rows into rank r's pool) and the
    ranks' delta into JAX: rows equal the delta's values by id."""
    ref, ranks = scenario(S, exchange)
    total = 0
    for r, res in enumerate(ranks):
        z = np.load(os.path.join(ref["jax_delta"], f"sparse-s{r}.npz"))
        assert len(z["fids"]) > 0
        total += len(z["fids"])
        np.testing.assert_array_equal(res["jax_delta_rows"], z["values"])
        assert res["jax_delta_step"] == 2
    assert all(res["jax_delta_applied"] == total for res in ranks)
    port_delta, n = ranks[0]["port_delta"], 0
    for s in range(S):
        z = np.load(os.path.join(port_delta, f"sparse-s{s}.npz"))
        n += len(z["fids"])
        np.testing.assert_array_equal(ref["port_delta_rows"][s],
                                      z["values"])
    assert ref["port_delta_applied"] == n > 0


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_deltas_refused_where_they_cannot_apply(S, exchange):
    """Another shard count and a multi-host trainer raise named errors."""
    _, ranks = scenario(S, exchange)
    assert all(res["mismatch_raised"] for res in ranks)
    assert all(res["multihost_delta_raised"] for res in ranks)


def test_r7_r8_faults_of_the_jax_deltas():
    """R7: the JAX save_delta fails on a trainer whose process holds only
    some stores. R8: the JAX restore_delta of a one-shard delta into two
    shards puts ids into shard 0 that shard 1 owns. The port refuses
    both (test above)."""
    ref, _ = scenario(2, "allgather")
    assert ref["r7"] is not None and "save" in ref["r7"]
    assert ref["r8"]["owned_by_1"] > 0
    assert ref["r8"]["misplaced"] == ref["r8"]["owned_by_1"]


# ----------------------------------------------------------------------
# the engine's tiered prepares at S > 1, in process
# ----------------------------------------------------------------------

def _twin_engines(S, shard=None, **cfg):
    kw = dict(embedding_dim=4, capacity_per_shard=256, ttl_seconds=10)
    jtask, ptask = JaxDeepFMTask(**kw), DeepFMTask(**kw)
    cfg = dict(num_shards=S, unique_cap=64, new_cap=24, tiered=True, **cfg)
    je = JaxEngine(jtask.tables(), jtask.features(), JaxEngineConfig(**cfg),
                   seed=4)
    pe = EmbeddingEngine(ptask.tables(), ptask.features(),
                         EngineConfig(**cfg), seed=4, device="cpu",
                         shard=shard)
    return je, pe


def _fids(rng, B=16):
    return {"user_id": rng.integers(-1, 90, (B, 1)).astype(np.int64),
            "item_id": rng.integers(60, 200, (B, 1)).astype(np.int64),
            "hist_items": rng.integers(-1, 200, (B, 10)).astype(np.int64)}


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("exchange", ["allgather", "a2a"])
@pytest.mark.parametrize("packed", ["auto", "off"])
def test_tiered_prepares_revive_as_jax(S, exchange, packed):
    """prepare_shards / prepare_batch_a2a of a tiered engine of S shards:
    every array as the JAX engine's, the revives of shard s (JAX's [S, K]
    with a -1 tail) in the port's [S, m]; an engine built for one shard
    holds that archive alone and revives that shard's ids only."""
    je, pe = _twin_engines(S, packed=packed)
    _, own = _twin_engines(S, shard=1, packed=packed)
    assert [a is None for a in own.shard_archives["sparse"]] == \
        [s != 1 for s in range(S)]
    assert own.shard == 1 and own.archive_of("sparse") is \
        own.shard_archives["sparse"][1]
    rng = np.random.default_rng(S)
    prep = {"allgather": ("prepare_batch", "prepare_shards"),
            "a2a": ("prepare_batch_a2a", "prepare_batch_a2a")}[exchange]
    key = "revive_pos" if packed == "auto" else "revive_rows"
    width = pe.archive_of("sparse").width
    revived_any = False
    for step in range(4):
        fb = _fids(rng)
        j, _ = getattr(je, prep[0])(fb, ts=step)
        p, _ = getattr(pe, prep[1])(fb, ts=step)
        o, _ = getattr(own, prep[1])(fb, ts=step)
        jt, pt, ot = j["sparse"], p["sparse"], o["sparse"]
        for k in ("rows", "new_mask", "new_pos", "new_rows", "bucket_idx"):
            if k in jt:
                np.testing.assert_array_equal(pt[k], jt[k], k)
                np.testing.assert_array_equal(ot[k], jt[k], k)
        assert pt[key].shape[:1] == (S,) and ot[key].shape[:1] == (S,)
        for s in range(S):
            n = int((jt[key][s] >= 0).sum())
            np.testing.assert_array_equal(pt[key][s][:n], jt[key][s][:n])
            assert (pt[key][s][n:] == -1).all()
            np.testing.assert_array_equal(pt["revive_values"][s][:n],
                                          jt["revive_values"][s][:n])
            assert pt["revive_values"].shape[2] == width
            got = ot[key][s][ot[key][s] >= 0]
            if s == 1:
                np.testing.assert_array_equal(got, jt[key][s][:n])
            else:
                assert len(got) == 0
            revived_any |= n > 0
        # spill every shard's ids of this step into the archives alike
        for s in range(S):
            rows, fids = je.stores["sparse"][s].evict_expired(
                step + 1, return_fids=True)
            for eng in (pe, own):
                erows, efids = eng.shard_stores["sparse"][s].evict_expired(
                    step + 1, return_fids=True)
                np.testing.assert_array_equal(efids, fids)
            vals = np.random.default_rng(step).standard_normal(
                (len(fids), width)).astype(np.float32)
            je.archives["sparse"][s].spill(fids, vals, ts=step)
            for eng in (pe, own):
                a = eng.shard_archives["sparse"][s]
                if a is not None:
                    a.spill(fids, vals, ts=step)
    assert revived_any

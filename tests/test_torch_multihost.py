"""The port's MultiHostTrainer over 2 and 4 gloo ranks on the CPU against
the JAX package's MultiHostTrainer on 2 and 4 virtual CPU devices.

Each S starts once (cached for the module): the JAX trainer takes one step
from its own init (DeepFM at init_scale=0.0, tiered, a ttl, touches
recorded) and its state, with all S shards' pools and host stores, is
carried by convert.py to S rank processes (tests/torch_multihost_worker.py,
gloo, one thread each): rank r loads pool r and store r alone and is fed
rows [r*b, (r+1)*b) of every global batch, which is what the JAX package's
one process hands its device r. The ranks run while the JAX trainer runs
the same batches here. Held exactly: each rank's local-prepare wire
against JAX's `wire[r]`, byte for byte; the owner map's received ids,
rows, positions and mask against JAX's map callback; every shard's host
store (ids -> rows, touch times, counts), so that the pools compare row
for row. Held at rtol 1e-5 / atol 1e-6 (the collectives reduce in another
order than JAX's): the pools and optimizer slots, the dense params and
optimizer state, the losses and the global predictions after steps, a
synchronous and an asynchronous block, a block that revives spilled rows;
the global `evaluate` (the same on every rank); admission with a
threshold. Expiry and the spill are held through the checkpoint files
(the JAX trainer zeroes freed rows in its next step and in the saved
copy, the port's at once). Checkpoints go both ways and 2 -> 4 against the
JAX package's restore of the same files, and fold into the port's
Trainer; an export is served by both packages' ServingModel; a streaming
round pushes each rank's own rows; the Estimator resumes on 2 ranks; a
step makes 1 + 2 x (wire dtypes) all-to-alls.
"""

import functools
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.parallel.multihost import MultiHostTrainer as JaxMultiHost
from monolith_tpu.serving.engine import ServingModel as JaxServingModel
from monolith_tpu.training import checkpoint as jckpt
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.embedding.host_store import shard_of_batch
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.serving.engine import ServingModel
from monolith_tpu_torch.training import checkpoint as pckpt
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

from torch_sharded_worker import start_ranks, wait_ranks

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multihost_worker.py")
TASK = dict(embedding_dim=8, capacity_per_shard=1024, hidden=(16,),
            init_scale=0.0, ttl_seconds=10)
ENGINE = dict(unique_cap=128, new_cap=128, tiered=True, record_touch=True)
SEED, B, STEPS, K = 11, 64, 3, 3
# steps at ts 1-3, a block at 4, the spill of ids last updated before 3,
# a block at 6, a step at 8, expiry of ids not updated since 7
TS0, SPILL_BEFORE, POST_TS, LAST_TS, EVICT_BEFORE = 1, 3, 6, 8, 7
USERS, ITEMS = 200, 100
SAVED_STEP = STEPS + 2 * K + 2
RTOL, ATOL = 1e-5, 1e-6


def jax_trainer(S, task=TASK, **engine):
    cfg = JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=S, **dict(ENGINE, **engine)),
        log_every=0, seed=SEED)
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("d",))
    return JaxMultiHost(JaxDeepFMTask(**task), cfg, mesh)


def spy_jax(jt, S):
    """Record the JAX trainer's local prepares (wire [S, S, W]) and its map
    callback's calls by shard (received ids, rows, positions, mask)."""
    rec = {"wire": [], "map": {s: [] for s in range(S)}}
    prepare, make_cb = jt._prepare_local, jt._make_map_callback

    def prepare_spy(fb):
        inputs, stats = prepare(fb)
        rec["wire"].append(np.array(inputs["wire"]))
        return inputs, stats

    def make_spy():
        cb = make_cb()

        def spy(recv, shard_idx):
            out = cb(recv, shard_idx)
            rec["map"][int(shard_idx)].append(
                (np.array(recv),) + tuple(np.array(o) for o in out[:3]))
            return out
        return spy
    jt._prepare_local, jt._make_map_callback = prepare_spy, make_spy
    return rec


def jax_snapshot(jt):
    st = convert.jax_trainer_state(jt)
    return {"pools": st["tables"], "stores": st["stores"],
            "params": st["params"], "opt_state": st["opt_state"]}


@functools.lru_cache(maxsize=None)
def scenario(S):
    """(JAX results, every rank's results) for S shards."""
    work = tempfile.mkdtemp(prefix=f"torch_multihost_S{S}_")
    data = JaxSyntheticCTR(num_users=USERS, num_items=ITEMS, batch_size=B,
                           seed=SEED)
    pair0 = data.batch()
    pairs = [data.batch() for _ in range(STEPS + K)]
    post = [data.batch() for _ in range(K)]
    last = data.batch()
    evals = [data.batch() for _ in range(2)]
    jt = jax_trainer(S)
    rec = spy_jax(jt, S)
    jt.train_step(*pair0, ts=0)
    jt._sync_inflight()   # its map callback has run (see the async block)
    rec["wire"].clear()
    for calls in rec["map"].values():
        calls.clear()
    dirs = {k: os.path.join(work, k) for k in
            ("port_ckpt", "jax_ckpt", "export", "estimator", "jax_adm",
             "sharded", "single")}
    # a single-device Trainer's checkpoint, for the ranks' 1 -> S restore
    single = Trainer(DeepFMTask(**TASK), TrainerConfig(
        engine=EngineConfig(unique_cap=ENGINE["unique_cap"],
                            new_cap=ENGINE["new_cap"]), seed=SEED),
        device="cpu")
    for i, pair in enumerate([pair0] + pairs[:2]):
        single.train_step(*pair, ts=i)
    pckpt.save(single, dirs["single"])
    job = {"task": TASK, "engine": dict(ENGINE, num_shards=S), "seed": SEED,
           "state0": convert.jax_trainer_state(jt), "pairs": pairs,
           "post": post, "last": last, "evals": evals, "steps": STEPS,
           "K": K, "ts0": TS0, "spill_before": SPILL_BEFORE,
           "post_ts": POST_TS, "last_ts": LAST_TS,
           "evict_before": EVICT_BEFORE, "ckpt_dir": dirs["port_ckpt"],
           "export_dir": dirs["export"], "sharded_dir": dirs["sharded"],
           "single_dir": dirs["single"]}
    jad = None
    if S == 2:
        adm_task = dict(TASK, admission_threshold=2)
        jad = jax_trainer(S, task=adm_task)
        jad.train_step(*pair0, ts=0)
        jckpt.save_distributed(jad, dirs["jax_adm"])
        job.update(admission={"task": adm_task, "jax_ckpt": dirs["jax_adm"],
                              "pairs": pairs[:STEPS]},
                   estimator_dir=dirs["estimator"], census=True)
    else:
        job["reshard_from"] = scenario(2)[0]["dirs"]["port_ckpt"]
    handle = start_ranks(S, job, WORKER)   # the ranks run while JAX runs
    try:
        ref = {"dirs": dirs, "evals": evals, "steps": []}
        for i in range(STEPS):
            out = jt.train_step(*pairs[i], ts=TS0 + i)
            ref["steps"].append({"loss": float(out["loss"]),
                                 "preds": np.asarray(out["preds"]),
                                 "stats": out["stats"]})
        ref["after_steps"] = jax_snapshot(jt)
        out = jt.train_step_block(pairs[STEPS:], ts=TS0 + STEPS)
        ref["block"] = {"loss": np.asarray(out["loss"]),
                        "preds": np.asarray(out["preds"]),
                        "stats": out["stats"]}
        ref["after_block"] = jax_snapshot(jt)
        ref["host"] = {"wire": list(rec["wire"]),
                       "map": {s: list(c) for s, c in rec["map"].items()}}
        ref["eval"] = jt.evaluate(iter(evals))
        ref["spilled"] = jt.spill_expired(SPILL_BEFORE)
        ref["archives"] = [convert.jax_archives(jt, s) for s in range(S)]
        out = jt.train_step_block(post, ts=POST_TS)
        ref["post"] = {"loss": np.asarray(out["loss"]),
                       "revived": sum(a.revived for a in
                                      jt.engine.archives["sparse"])}
        ref["after_post"] = jax_snapshot(jt)
        ref["last"] = float(jt.train_step(*last, ts=LAST_TS)["loss"])
        ref["freed"] = jt.evict_expired(EVICT_BEFORE)
        jckpt.save_distributed(jt, dirs["jax_ckpt"])
        ja = jax_trainer(S, async_optimize=True)
        ja.train_step(*pair0, ts=0)
        # the JAX map callback reads the trainer's ts when it runs, so the
        # step must have run before the next call sets another
        ja._sync_inflight()
        out = ja.train_step_block(pairs[:K], ts=TS0)
        ref["async"] = dict(jax_snapshot(ja), loss=np.asarray(out["loss"]),
                            preds=np.asarray(out["preds"]))
        if jad is not None:
            ref["admission"] = []
            for i, pair in enumerate(pairs[:STEPS]):
                out = jad.train_step(*pair, ts=1 + i)
                ref["admission"].append({"loss": float(out["loss"]),
                                         "stats": out["stats"]})
            ref["admission_after"] = jax_snapshot(jad)
            ref["admission_seen"] = len(np.unique(np.concatenate(
                [v.ravel() for fb, _ in [pair0] + pairs[:STEPS]
                 for v in fb.values()])))
    except BaseException:
        try:       # stop the ranks; the JAX side's error is the one to see
            wait_ranks(handle, timeout=1)
        except AssertionError:
            pass
        raise
    ranks = wait_ranks(handle)
    ref["single"] = convert.export_state(single)
    # the port's checkpoint restored by the JAX package (into the
    # asynchronous trainer, whose state differs from it)
    ref["restored_step"] = jckpt.restore(ja, dirs["port_ckpt"])
    ref["restored"] = jax_snapshot(ja)
    if S == 4:
        # 2 -> 4: the JAX package's restore of the port's S = 2 files
        ref["reshard_step"] = jckpt.restore(jt, job["reshard_from"])
        ref["reshard"] = jax_snapshot(jt)
    return ref, ranks


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def close_tree(a, b, what):
    fa, fb = convert._flatten(a), convert._flatten(b)
    assert set(fa) == set(fb), what
    for k in fa:
        close(fa[k], fb[k], f"{what} {k}")


def same_store(a, b, what):
    for x, y, name in zip(a, b, ("fids", "rows", "tss", "counts")):
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")


def check_state(snaps, ref, what):
    """Each rank's store (exactly) and pool against JAX's shard, and the
    dense state against JAX's."""
    for r, snap in enumerate(snaps):
        for t, pool in snap["pool"].items():
            same_store(snap["stores"][t], ref["stores"][t][r],
                       f"{what}: store {r} of {t}")
            close(pool, ref["pools"][t][r], f"{what}: shard {r} of {t}")
        close_tree(snap["params"], ref["params"], f"{what}: params")
        close_tree(snap["opt_state"], ref["opt_state"], f"{what}: opt_state")


def main(ranks):
    return [r["main"] for r in ranks]


SHARDS = [2, 4]


@pytest.mark.parametrize("S", SHARDS)
def test_rank_holds_only_its_own_store(S):
    _, ranks = scenario(S)
    for r, res in enumerate(main(ranks)):
        assert res["held"] == {"sparse": [s == r for s in range(S)]}


@pytest.mark.parametrize("S", SHARDS)
def test_local_prepare_wire_is_jax_byte_for_byte(S):
    ref, ranks = scenario(S)
    want = ref["host"]["wire"][:STEPS + K]
    for r, res in enumerate(main(ranks)):
        got = res["host"]["wire"][:STEPS + K]
        assert len(got) == len(want) == STEPS + K
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype == np.int32
            assert g.tobytes() == w[r].tobytes(), (r, i)


@pytest.mark.parametrize("S", SHARDS)
def test_owner_map_equals_jax_callback(S):
    """The ids each owner receives (a2a#1) and what its map makes of them:
    rows, bucket positions and the new-row mask, step for step."""
    ref, ranks = scenario(S)
    for r, res in enumerate(main(ranks)):
        got = res["host"]["map"][:STEPS + K]
        want = ref["host"]["map"][r][:STEPS + K]
        assert len(got) == len(want) == STEPS + K
        for i, (g, w) in enumerate(zip(got, want)):
            for x, y, name in zip(g, w, ("recv", "rows", "pos", "mask")):
                np.testing.assert_array_equal(x, y, f"rank {r} {i} {name}")
        assert any((w[3] > 0).any() for w in want)   # ids were admitted


@pytest.mark.parametrize("S", SHARDS)
def test_steps_and_sync_block_match_jax(S):
    ref, ranks = scenario(S)
    for r, res in enumerate(main(ranks)):
        for i, (p, j) in enumerate(zip(res["steps"], ref["steps"])):
            close(p["loss"], j["loss"], f"rank {r} step {i} loss")
            assert p["preds"].shape == (B,)
            close(p["preds"], j["preds"], f"rank {r} step {i} preds")
            assert p["stats"] == j["stats"], (r, i)
        close(res["block"]["loss"], ref["block"]["loss"], f"rank {r}")
        assert res["block"]["preds"].shape == (K, B)
        close(res["block"]["preds"], ref["block"]["preds"], f"rank {r}")
        assert res["block"]["stats"] == ref["block"]["stats"]
    check_state([m["after_steps"] for m in main(ranks)], ref["after_steps"],
                "after the steps")
    check_state([m["after_block"] for m in main(ranks)], ref["after_block"],
                "after the block")


@pytest.mark.parametrize("S", SHARDS)
def test_async_block_matches_jax(S):
    ref, ranks = scenario(S)
    for r, res in enumerate(main(ranks)):
        close(res["async"]["loss"], ref["async"]["loss"], f"rank {r} loss")
        close(res["async"]["preds"], ref["async"]["preds"], f"rank {r}")
    check_state([m["async"]["after"] for m in main(ranks)], ref["async"],
                "after the asynchronous block")


@pytest.mark.parametrize("S", SHARDS)
def test_evaluate_is_global_and_matches_jax(S):
    ref, ranks = scenario(S)
    for res in main(ranks):
        close(res["eval"]["loss"], ref["eval"]["loss"], "eval loss")
        close(res["eval"]["auc"], ref["eval"]["auc"], "eval auc")
        assert res["eval"] == main(ranks)[0]["eval"]


@pytest.mark.parametrize("S", SHARDS)
def test_spill_and_revive_in_a_block_match_jax(S):
    """Each rank spills its own shard's expired rows into its own archive;
    the next block revives them (at its pack, step by step) as the JAX
    owners do in their callbacks."""
    ref, ranks = scenario(S)
    assert sum(sum(m["spilled"].values()) for m in main(ranks)) == \
        sum(ref["spilled"].values()) > 0
    revived = sum(m["post"]["revived"]["sparse"] for m in main(ranks))
    assert revived == ref["post"]["revived"] > 0
    for r, res in enumerate(main(ranks)):   # rank r's archive is JAX's r
        got, want = res["archives"]["sparse"], ref["archives"][r]["sparse"]
        assert set(got) == set(want) and len(want["fids"]) > 0
        for k in want:
            if k == "values":
                close(got[k], want[k], f"archive {r}")
            else:
                np.testing.assert_array_equal(got[k], want[k], f"{r} {k}")
    for r, res in enumerate(main(ranks)):
        close(res["post"]["loss"], ref["post"]["loss"], f"rank {r}")
        close(res["last"], ref["last"], f"rank {r}")
    check_state([m["after_post"] for m in main(ranks)], ref["after_post"],
                "after the revive")


@pytest.mark.parametrize("S", SHARDS)
def test_expiry_and_checkpoint_files_match_jax(S):
    """After spill, revive and expiry: rank r's freed rows are JAX's of
    shard r, and the files of the port's `save_distributed` hold what the
    JAX package's hold (stores and archives exactly, pools and slots
    within tolerance)."""
    ref, ranks = scenario(S)
    cap = TASK["capacity_per_shard"]
    jfreed = ref["freed"]["sparse"]
    assert len(jfreed) > 0
    for r, res in enumerate(main(ranks)):
        np.testing.assert_array_equal(res["freed"]["sparse"],
                                      jfreed[jfreed // cap == r])
    pdir, jdir = ref["dirs"]["port_ckpt"], ref["dirs"]["jax_ckpt"]
    step = SAVED_STEP
    assert sorted(os.listdir(os.path.join(pdir, f"ckpt-{step}", "archives"))
                  ) == [f"sparse-s{s}.npz" for s in range(S)]
    assert pckpt.latest_step(pdir) == step
    import json
    metas = [json.load(open(os.path.join(d, f"ckpt-{step}", "meta.json")))
             for d in (pdir, jdir)]
    assert metas[0]["tables"] == metas[1]["tables"] == {
        "sparse": {"shards": S, "dim": TASK["embedding_dim"] + 1}}
    for s in range(S):
        for sub in ("tables", "archives"):
            f = os.path.join(f"ckpt-{step}", sub, f"sparse-s{s}.npz")
            p = np.load(os.path.join(pdir, f))
            j = np.load(os.path.join(jdir, f))
            assert set(p.files) == set(j.files), (sub, s)
            for k in p.files:
                if p[k].dtype.kind == "f":
                    close(p[k], j[k], f"{sub} s{s} {k}")
                else:
                    np.testing.assert_array_equal(p[k], j[k], f"{sub} {s} {k}")


@pytest.mark.parametrize("S", SHARDS)
def test_port_checkpoint_restores_in_jax(S):
    """The JAX package restores the port's per-shard files into a trainer
    whose state was another: every shard's store and pool, the dense
    state, as the ranks saved them."""
    ref, ranks = scenario(S)
    assert ref["restored_step"] == SAVED_STEP
    check_state([m["final"] for m in main(ranks)], ref["restored"],
                "the port's checkpoint in JAX")


def test_jax_checkpoint_restores_in_the_port_and_admission_matches():
    """A threshold-2 table: the JAX package's checkpoint (filters
    included) restored by 2 ranks, then steps whose admissions need the
    requesters' occurrence counts summed at the owners."""
    ref, ranks = scenario(2)
    adm = [r["admission"] for r in ranks]
    assert all(a["restored_step"] == 1 for a in adm)
    for r, a in enumerate(adm):
        for i, (p, j) in enumerate(zip(a["steps"], ref["admission"])):
            close(p["loss"], j["loss"], f"rank {r} step {i}")
            assert p["stats"] == j["stats"]
    check_state([a["after"] for a in adm], ref["admission_after"],
                "admission")
    # the filter admitted some ids and held others back
    live = sum(len(a["after"]["stores"]["sparse"][0]) for a in adm)
    assert 0 < live < ref["admission_seen"], (live, ref["admission_seen"])


def test_reshard_2_to_4_equals_jax_restore():
    ref, ranks = scenario(4)
    assert ref["reshard_step"] == SAVED_STEP
    snaps = [r["reshard_from"]["after"] for r in ranks]
    assert all(r["reshard_from"]["step"] == ref["reshard_step"] for r in ranks)
    check_state(snaps, ref["reshard"], "2 -> 4")
    for r, snap in enumerate(snaps):
        fids = snap["stores"]["sparse"][0]
        assert (shard_of_batch(fids, 4) == r).all()


def _by_id(snaps):
    """{fid: (pool row, ts, count)} over ranks' snapshots."""
    out = {}
    for snap in snaps:
        fids, rows, tss, counts = snap["stores"]["sparse"]
        for f, row, t, c in zip(fids, rows, tss, counts):
            out[int(f)] = (snap["pool"]["sparse"][row], int(t), int(c))
    return out


def test_checkpoint_folds_into_the_port_trainer():
    ref, ranks = scenario(2)
    tr = Trainer(DeepFMTask(**TASK), TrainerConfig(
        engine=EngineConfig(**ENGINE), seed=SEED), device="cpu")
    assert pckpt.restore(tr, ref["dirs"]["port_ckpt"]) == SAVED_STEP
    snap = {"stores": {"sparse": tr.engine.stores["sparse"].save()},
            "pool": {"sparse": tr.table_states["sparse"]["data"].numpy()}}
    got, want = _by_id([snap]), _by_id([m["final"] for m in main(ranks)])
    assert set(got) == set(want) and len(got) > 0
    for f, (row, t, c) in want.items():
        np.testing.assert_array_equal(got[f][0], row)
        assert got[f][1:] == (t, c)
    close_tree(convert.dense_tree(tr.module.named_parameters()),
               main(ranks)[0]["final"]["params"], "dense")


def test_export_served_by_both_packages():
    """The ranks' export (rank r's shard file, rank 0's dense and meta)
    merges in one ServingModel of either package, which answers the
    global batch as the trainer's predict did on the ranks."""
    ref, ranks = scenario(2)
    path = os.path.join(ref["dirs"]["export"], f"export-{SAVED_STEP}")
    assert sorted(os.listdir(os.path.join(path, "tables"))) == \
        ["sparse-s0.npz", "sparse-s1.npz"]
    fb, b = ref["evals"][0]
    port = ServingModel(DeepFMTask(**TASK), path, device="cpu",
                        unique_cap=512).predict(fb, b)
    jaxs = JaxServingModel(JaxDeepFMTask(**TASK), path,
                           unique_cap=512).predict(fb, b)
    want = main(ranks)[0]["predict"]
    assert want.shape == (B,)
    np.testing.assert_allclose(port, want, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(jaxs), want, rtol=1e-4)


@pytest.mark.parametrize("S", SHARDS)
def test_streaming_round_pushes_each_ranks_rows(S):
    """Each rank drains its own store's touched ids and pushes its own
    pool's rows; together the ranks push every live id that the run
    touched."""
    _, ranks = scenario(S)
    pushed = set()
    for r, res in enumerate(main(ranks)):
        fids, values, equal = res["pushes"]["sparse"]
        assert equal and len(fids) == res["pushed"]["sparse"] > 0
        assert (shard_of_batch(fids, S) == r).all()
        assert res["touched_left"] == {"sparse": 0}
        pushed |= set(fids.tolist())
    live = set()
    for res in main(ranks):
        live |= set(res["final"]["stores"]["sparse"][0].tolist())
    assert live <= pushed


def test_estimator_resumes_on_two_ranks():
    _, ranks = scenario(2)
    for res in (r["estimator_dir"] for r in ranks):
        assert res["multihost"] and res["shards"] == 2
        assert res["first"] == 3 and res["second"] == 5
        assert res["restored_equal"]


def test_exchange_census():
    """a2a#1 (int32 ids) and one a2a#2 and one a2a#3 per wire dtype,
    whatever the number of tables; bf16 tables exchange in bf16."""
    _, ranks = scenario(2)
    for res in (r["census"] for r in ranks):
        assert res["f32_1"]["tables"] == 2 and res["f32_3"]["tables"] == 4
        for name in ("f32_1", "f32_3"):
            assert res[name]["calls"] == ["torch.int32", "torch.float32",
                                          "torch.float32"], res[name]
        assert res["bf16_3"]["calls"] == ["torch.int32", "torch.bfloat16",
                                          "torch.bfloat16"]
        assert all(np.isfinite(v["loss"]) for v in res.values())


def test_controller_status_reports_the_ranks_own_shard():
    """The status RPC reports each rank's own shard (fault F4: the port's
    reported the single-shard view only, so no table of a sharded
    trainer). The JAX controller reads every shard's store, and a
    multi-process rank holds None for the others' (fault R5 of the
    reference, pinned on its single-device trainer given that layout)."""
    from monolith_tpu.models.deepfm import DeepFMTask as JTask
    from monolith_tpu.training.controller import \
        TrainingController as JaxController
    from monolith_tpu.training.trainer import Trainer as JaxTrainer
    _, ranks = scenario(2)
    for r, res in enumerate(main(ranks)):
        live = len(res["final"]["stores"]["sparse"][0])
        assert res["status"] == {f"table:sparse:s{r}:size": live}
    jt = JaxTrainer(JTask(**TASK), JaxTrainerConfig(log_every=0))
    jt.engine.stores["sparse"] = [None, jt.engine.stores["sparse"][0]]
    ctl = JaxController(jt)
    try:
        with pytest.raises(AttributeError):
            ctl._rpc_status(None, None)
    finally:
        ctl._server.stop(0)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_trainer_checkpoints_per_shard(S):
    """A ShardedTrainer's ranks write one file a shard; a fresh
    ShardedTrainer restores every store and its own pool exactly, and a
    MultiHostTrainer of the same S its own store and pool."""
    _, ranks = scenario(S)
    for r, res in enumerate(x["sharded_dir"] for x in ranks):
        assert res["files"] == [f"sparse-s{s}.npz" for s in range(S)]
        assert res["step"] == 3
        saved, back = res["saved"], res["restored"]
        for s in range(S):
            same_store(back["stores"]["sparse"][s],
                       saved["stores"]["sparse"][s], f"rank {r} store {s}")
        np.testing.assert_array_equal(back["tables"]["sparse"],
                                      saved["tables"]["sparse"])
        mh = res["multihost"]
        same_store(mh["stores"]["sparse"], saved["stores"]["sparse"][r],
                   f"rank {r}")
        np.testing.assert_array_equal(mh["pool"]["sparse"],
                                      saved["tables"]["sparse"][0])
        close_tree(mh["params"], saved["params"], "params")


def test_single_device_checkpoint_restores_1_to_n():
    """A single-device Trainer's checkpoint into 2 ranks: each keeps the
    entries routed to its shard, together every entry, rows by id equal."""
    ref, ranks = scenario(2)
    snaps = [x["sharded_dir"]["from_single"] for x in ranks]
    for r, snap in enumerate(snaps):
        fids = snap["stores"]["sparse"][0]
        assert len(fids) > 0 and (shard_of_batch(fids, 2) == r).all()
    st = ref["single"]
    want = _by_id([{"stores": {"sparse": st["stores"]["sparse"]},
                    "pool": {"sparse": st["tables"]["sparse"][0]}}])
    got = _by_id(snaps)
    assert set(got) == set(want)
    for f, (row, t, c) in want.items():
        np.testing.assert_array_equal(got[f][0], row)
        assert got[f][1:] == (t, c)

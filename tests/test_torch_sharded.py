"""The port's ShardedTrainer over 2 and 4 gloo ranks on the CPU against the
JAX package's ShardedTrainer on 2 and 4 virtual CPU devices.

Each (S, exchange) scenario starts once (cached for the module): the JAX
trainer takes one step from its own init (DeepFM at init_scale=0.0, so
new rows start at zero in both packages) and its state, with all S
shards' pools and host stores, is carried to S rank processes
(tests/torch_sharded_worker.py, gloo, one thread each), which run the
port's trainers while the JAX trainer runs the same batches here. Then:

- per-step steps and a synchronous block: losses, the global predictions,
  every shard's pool, dense params and optimizer state within rtol 1e-5 /
  atol 1e-6 (the collectives reduce in another order than JAX's
  psum_scatter, so f32 rounding apart); the host stats exactly;
- the asynchronous (1-step-stale) block the same way, and no update lost
  against the synchronous block (tests/test_sharded.py's criterion);
- evaluate, also of the a2a-trained state loaded into an allgather
  trainer (exactly); expiry (every rank frees the same rows and zeroes
  its own shard's); predict answers the global batch;
- within the port, bit for bit: a block equals its steps, `train()` in
  blocks (the staging lookahead run) equals `train()` step by step, the
  dense params are equal on every rank after every step, every rank's
  host prepare arrays hash alike; a2a equals allgather to f32 rounding;
- the mesh-size refusal and bucket overflow counted.
"""

import functools

import numpy as np
import pytest

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from monolith_tpu.parallel import make_mesh as jax_make_mesh
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert

from torch_sharded_worker import start_ranks, wait_ranks

TASK = dict(embedding_dim=8, capacity_per_shard=1024, hidden=(16,),
            init_scale=0.0, ttl_seconds=10)
ENGINE = dict(unique_cap=128, new_cap=128)
SEED, B, STEPS, K = 11, 64, 3, 3
EXPIRE_BEFORE = 3      # after steps at ts 1-3, a block at 4, eval at 0
RTOL, ATOL = 1e-5, 1e-6
SCENARIOS = [(2, "allgather"), (2, "a2a"), (4, "allgather"), (4, "a2a")]
IDS = [f"S{s}-{e}" for s, e in SCENARIOS]
OVERFLOW_CAP = 2


def jax_trainer(S, exchange, **engine):
    cfg = JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=S, exchange=exchange,
                               **dict(ENGINE, **engine)),
        log_every=0, seed=SEED)
    return JaxShardedTrainer(JaxDeepFMTask(**TASK), cfg, jax_make_mesh(S))


def _jax_snapshot(jt):
    st = convert.jax_trainer_state(jt)
    return {"pools": st["tables"], "params": st["params"],
            "opt_state": st["opt_state"]}


@functools.lru_cache(maxsize=None)
def scenario(S, exchange):
    """(JAX results, every rank's results) of one scenario."""
    data = JaxSyntheticCTR(num_users=60, num_items=40, batch_size=B,
                           seed=SEED)
    pair0 = data.batch()
    pairs = [data.batch() for _ in range(STEPS + K)]
    evals = [data.batch() for _ in range(2)]
    jt = jax_trainer(S, exchange)
    jt.train_step(*pair0, ts=0)
    job = {"task": TASK, "engine": dict(ENGINE, num_shards=S,
                                        exchange=exchange),
           "seed": SEED, "state0": convert.jax_trainer_state(jt),
           "pairs": pairs, "evals": evals, "ts0": 1, "steps": STEPS, "K": K,
           "expire_before": EXPIRE_BEFORE}
    jo = None
    if exchange == "a2a":
        odata = JaxSyntheticCTR(num_users=500, num_items=300, batch_size=B,
                                seed=19)
        opairs = [odata.batch(), odata.batch()]
        jo = jax_trainer(S, exchange, bucket_cap=OVERFLOW_CAP)
        jo.train_step(*opairs[0], ts=0)
        job["overflow"] = {"state": convert.jax_trainer_state(jo),
                           "pair": opairs[1], "ts": 1,
                           "bucket_cap": OVERFLOW_CAP}
    handle = start_ranks(S, job)   # the ranks run while JAX runs here
    try:
        ref = {"steps": []}
        for i in range(STEPS):
            out = jt.train_step(*pairs[i], ts=1 + i)
            ref["steps"].append({"loss": float(out["loss"]),
                                 "preds": np.asarray(out["preds"]),
                                 "stats": out["stats"]})
        ref["after_steps"] = _jax_snapshot(jt)
        out = jt.train_step_block(pairs[STEPS:], ts=1 + STEPS)
        ref["block"] = {"loss": np.asarray(out["loss"]),
                        "preds": np.asarray(out["preds"]),
                        "stats": out["stats"]}
        ref["after_block"] = _jax_snapshot(jt)
        ref["eval"] = jt.evaluate(iter(evals))
        ref["freed"] = jt.evict_expired(EXPIRE_BEFORE)
        ref["after_evict"] = _jax_snapshot(jt)
        ja = jax_trainer(S, exchange, async_optimize=True)
        ja.train_step(*pair0, ts=0)
        out = ja.train_step_block(pairs[:K], ts=1)
        ref["async"] = dict(_jax_snapshot(ja),
                            loss=np.asarray(out["loss"]),
                            preds=np.asarray(out["preds"]))
        if jo is not None:
            out = jo.train_step(*job["overflow"]["pair"], ts=1)
            ref["overflow"] = dict(_jax_snapshot(jo),
                                   loss=float(out["loss"]),
                                   stats=out["stats"])
    except BaseException:
        try:       # stop the ranks; the JAX side's error is the one to see
            wait_ranks(handle, timeout=1)
        except AssertionError:
            pass
        raise
    return ref, wait_ranks(handle)


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
    """Dicts, lists and tuples of arrays equal leaf for leaf."""
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


def by_id(snap, table, shard):
    """A snapshot's pool rows of its shard's live ids, in id order."""
    fids, rows = snap["stores"][table][shard][:2]
    return snap["pool"][table][rows[np.argsort(fids)]]


def check_state(ranks, key, ref, what):
    """Every rank's pool against JAX's shard, the dense state against
    JAX's (each rank's)."""
    for r, res in enumerate(ranks):
        snap = res[key] if key else res
        for t, pool in snap["pool"].items():
            close(pool, ref["pools"][t][r], f"{what}: shard {r} of {t}")
        close_tree(snap["params"], ref["params"], f"{what}: params")
        close_tree(snap["opt_state"], ref["opt_state"], f"{what}: opt_state")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_steps_match_jax(S, exchange):
    ref, ranks = scenario(S, exchange)
    for r, res in enumerate(ranks):
        for i, (p, j) in enumerate(zip(res["steps"], ref["steps"])):
            close(p["loss"], j["loss"], f"rank {r} step {i} loss")
            assert p["preds"].shape == (B,)
            close(p["preds"], j["preds"], f"rank {r} step {i} preds")
            assert p["stats"] == j["stats"], (r, i)
    check_state(ranks, "after_steps", ref["after_steps"], "after the steps")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_sync_block_matches_jax(S, exchange):
    ref, ranks = scenario(S, exchange)
    for r, res in enumerate(ranks):
        close(res["block"]["loss"], ref["block"]["loss"], f"rank {r} loss")
        assert res["block"]["preds"].shape == (K, B)
        close(res["block"]["preds"], ref["block"]["preds"], f"rank {r}")
        assert res["block"]["stats"] == ref["block"]["stats"]
    check_state(ranks, "after_block", ref["after_block"], "after the block")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_async_block_matches_jax_and_loses_no_update(S, exchange):
    ref, ranks = scenario(S, exchange)
    for r, res in enumerate(ranks):
        close(res["async"]["loss"], ref["async"]["loss"], f"rank {r} loss")
        close(res["async"]["preds"], ref["async"]["preds"], f"rank {r}")
        assert np.isfinite(res["async"]["loss"]).all()
    check_state([res["async"]["after"] for res in ranks], None,
                ref["async"], "after the asynchronous block")
    for res in ranks:
        moved_async = sum(np.abs(p).sum()
                          for p in res["async"]["after"]["pool"].values())
        moved_sync = sum(np.abs(p).sum()
                         for p in res["sync_first_block"]["pool"].values())
        assert 0.5 * moved_sync < moved_async < 2.0 * moved_sync, (
            moved_async, moved_sync)


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_block_equals_its_steps_bit_for_bit(S, exchange):
    _, ranks = scenario(S, exchange)
    for r, res in enumerate(ranks):
        equal_tree(res["after_block"], res["sequential"], f"rank {r}")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_train_in_blocks_equals_train_in_steps(S, exchange):
    _, ranks = scenario(S, exchange)
    for r, res in enumerate(ranks):
        b, s = res["train_blocked"], res["train_steps"]
        assert b["staged"] >= 1, "the staging lookahead never ran"
        assert b["step"] == s["snap"]["step"] == 1 + 2 * K
        for k in ("pool", "params", "opt_state"):
            equal_tree(b["snap"][k], s["snap"][k], f"rank {r} {k}")
        assert b["loss"] == s["loss"] and b["auc"] == s["auc"]


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_dense_state_and_host_prepare_equal_on_every_rank(S, exchange):
    _, ranks = scenario(S, exchange)
    for res in ranks[1:]:
        for i, (p, q) in enumerate(zip(res["steps"], ranks[0]["steps"])):
            equal_tree(p["params"], q["params"], f"params after step {i}")
            np.testing.assert_array_equal(p["preds"], q["preds"])
            assert p["loss"] == q["loss"]
        equal_tree(res["after_block"]["params"],
                   ranks[0]["after_block"]["params"], "after the block")
        assert res["host_hashes"] == ranks[0]["host_hashes"]
    assert len(ranks[0]["host_hashes"]) >= 2 * (STEPS + K)


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_evaluate_matches_jax_and_allgather(S, exchange):
    ref, ranks = scenario(S, exchange)
    for res in ranks:
        close(res["eval"]["loss"], ref["eval"]["loss"], "eval loss")
        close(res["eval"]["auc"], ref["eval"]["auc"], "eval auc")
        assert res["eval_allgather"] == res["eval"]


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_evict_expired_zeroes_each_shard_as_jax(S, exchange):
    """Every rank evicts the same ids from all S host stores and zeroes its
    own shard's rows: the freed rows (s * capacity + row) and every
    shard's pool as the JAX trainer's."""
    ref, ranks = scenario(S, exchange)
    assert len(ref["freed"]["sparse"]) > 0
    for res in ranks:
        np.testing.assert_array_equal(res["freed"]["sparse"],
                                      ref["freed"]["sparse"])
    check_state(ranks, "after_evict", ref["after_evict"], "after expiry")


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_mesh_size_mismatch_raises(S, exchange):
    """A trainer whose num_shards is not the mesh's size, and a mesh of
    more ranks than the group has, are refused (tests/test_sharded.py:80,
    monolith_tpu/parallel/mesh.py:18-24)."""
    _, ranks = scenario(S, exchange)
    assert all(res["mismatch_raised"] for res in ranks)
    assert all(res["too_many_raised"] for res in ranks)


@pytest.mark.parametrize("S,exchange", SCENARIOS, ids=IDS)
def test_predict_is_the_global_batch(S, exchange):
    """predict answers the whole batch, on every rank alike."""
    _, ranks = scenario(S, exchange)
    for res in ranks:
        assert res["predict"].shape == (B,)
        np.testing.assert_array_equal(res["predict"], ranks[0]["predict"])


@pytest.mark.parametrize("S", [2, 4])
def test_a2a_equals_allgather(S):
    _, ag = scenario(S, "allgather")
    _, a2a = scenario(S, "a2a")
    for p, q in zip(ag, a2a):
        for i, (x, y) in enumerate(zip(p["steps"], q["steps"])):
            close(y["loss"], x["loss"], f"step {i}")
            close(y["preds"], x["preds"], f"step {i}")
        # the two dedups order the unique ids apart, so the host stores
        # give them other rows: compare the pools row by id
        for t in p["after_block"]["pool"]:
            close(by_id(q["after_block"], t, q["rank"]),
                  by_id(p["after_block"], t, p["rank"]), t)
        close_tree(q["after_block"]["params"], p["after_block"]["params"],
                   "params")


@pytest.mark.parametrize("S", [2, 4])
def test_bucket_overflow_counted(S):
    ref, ranks = scenario(S, "a2a")
    assert ref["overflow"]["stats"]["overflow"]["sparse"] > 0
    for r, res in enumerate(ranks):
        o = res["overflow"]
        assert o["stats"] == ref["overflow"]["stats"]
        assert np.isfinite(o["loss"])
        close(o["loss"], ref["overflow"]["loss"], "loss")
        for t, pool in o["after"]["pool"].items():
            close(pool, ref["overflow"]["pools"][t][r], f"shard {r}")

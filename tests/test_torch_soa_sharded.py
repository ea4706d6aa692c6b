"""The structure-of-arrays branches of the port's ShardedTrainer and
MultiHostTrainer (`EngineConfig(packed="off")`) over 2 gloo ranks on the
CPU against the JAX package's ShardedTrainer / MultiHostTrainer on 2
virtual CPU devices, and fault R6 of the JAX package pinned.

The JAX trainer takes one step from its own init (DeepFM, init_scale 0.0,
f32 tables) and its state, both shards' params and slots and host stores,
is carried by convert.py to the rank processes (tests/torch_soa_worker.py),
which run the same batches (the multi-host ranks their halves). Held at
rtol 1e-5 / atol 1e-6 (the collectives reduce in another order than
JAX's): losses and global predictions of 3 steps and a block of 3 (the
sharded trainer's block is synchronous on this layout; the multi-host's
too), every shard's params and Adagrad slots after each, the evaluation.

R6: the JAX ShardedTrainer's structure-of-arrays update passes no key to
`table.apply_gradients`, so every shard (and table) of a step rounds its
bf16 params with `fold_in(PRNGKey(0), step)`: the same noise on every
shard. The port keys each shard's K3 with (seed, step, table, shard).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from monolith_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from monolith_tpu.embedding.engine import EngineConfig as JaxEngineConfig
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu.ops import rounding as jrounding
from monolith_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from monolith_tpu.parallel import make_mesh as jax_make_mesh
from monolith_tpu.parallel.multihost import MultiHostTrainer as JaxMultiHost
from monolith_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from monolith_tpu_torch import convert
from monolith_tpu_torch.embedding import table as ptable
from monolith_tpu_torch.embedding.engine import (EmbeddingEngine,
                                                 EngineConfig, _round_seed)
from monolith_tpu_torch.models.deepfm import DeepFMTask

from torch_sharded_worker import start_ranks, wait_ranks

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_soa_worker.py")
TASK = dict(embedding_dim=8, capacity_per_shard=1024, hidden=(16,),
            init_scale=0.0)
ENGINE = dict(unique_cap=128, new_cap=128, packed="off")
SEED, B, STEPS, K, S = 11, 64, 3, 3, 2
RTOL, ATOL = 1e-5, 1e-6


def jax_trainer(kind, task=TASK, **engine):
    cfg = JaxTrainerConfig(
        engine=JaxEngineConfig(num_shards=S, **dict(ENGINE, **engine)),
        log_every=0, seed=SEED)
    if kind == "multihost":
        return JaxMultiHost(JaxDeepFMTask(**task), cfg,
                            Mesh(np.asarray(jax.devices()[:S]), ("d",)))
    return JaxShardedTrainer(JaxDeepFMTask(**task), cfg, jax_make_mesh(S))


@functools.lru_cache(maxsize=None)
def scenario(kind):
    """(JAX results, both ranks' results) of one trainer kind."""
    data = JaxSyntheticCTR(num_users=60, num_items=40, batch_size=B,
                           seed=SEED)
    pair0 = data.batch()
    pairs = [data.batch() for _ in range(STEPS + K)]
    evals = [data.batch() for _ in range(2)]
    jt = jax_trainer(kind)
    jt.train_step(*pair0, ts=0)
    job = {"kind": kind, "task": TASK, "engine": dict(ENGINE, num_shards=S),
           "seed": SEED, "state0": convert.jax_trainer_state(jt),
           "pairs": pairs, "evals": evals, "ts0": 1, "steps": STEPS, "K": K}
    handle = start_ranks(S, job, script=WORKER)
    try:
        ref = {"steps": []}
        for i in range(STEPS):
            out = jt.train_step(*pairs[i], ts=1 + i)
            ref["steps"].append({"loss": float(out["loss"]),
                                 "preds": np.asarray(out["preds"])})
        ref["after_steps"] = convert.jax_trainer_state(jt)["tables"]
        out = jt.train_step_block(pairs[STEPS:], ts=1 + STEPS)
        ref["block"] = {"loss": np.asarray(out["loss"]),
                        "preds": np.asarray(out["preds"])}
        ref["after_block"] = convert.jax_trainer_state(jt)["tables"]
        ref["eval"] = jt.evaluate(iter(evals))
    except BaseException:
        try:
            wait_ranks(handle, timeout=1)
        except AssertionError:
            pass
        raise
    return ref, wait_ranks(handle)


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("kind", ["sharded", "multihost"])
def test_soa_ranks_match_jax(kind):
    ref, ranks = scenario(kind)
    for res in ranks:
        r = res["rank"]
        for i, (p, j) in enumerate(zip(res["steps"], ref["steps"])):
            close(p["loss"], j["loss"], f"rank {r} step {i} loss")
            close(p["preds"], j["preds"], f"rank {r} step {i} preds")
        close(res["block"]["loss"], ref["block"]["loss"], "block loss")
        close(res["block"]["preds"], ref["block"]["preds"], "block preds")
        for stage in ("after_steps", "after_block"):
            jv, pv = ref[stage]["sparse"], res[stage]["sparse"]
            assert isinstance(pv, dict) and isinstance(jv, dict)
            close(pv["params"][0], jv["params"][r], f"{stage} params {r}")
            for i, seg in enumerate(jv["slots"]):
                for name in seg:
                    close(pv["slots"][i][name][0], seg[name][r],
                          f"{stage} seg{i}/{name} {r}")
        assert abs(res["eval"]["auc"] - ref["eval"]["auc"]) <= 1e-6
        close(res["eval"]["loss"], ref["eval"]["loss"], "eval loss")


def test_r6_jax_sharded_rounds_every_shard_with_one_key(monkeypatch):
    """Fault R6, pinned in both packages. JAX: a bf16 stochastic-rounding
    table under ShardedTrainer(packed="off") on 2 devices, with the
    rounding replaced by a fill with one number drawn from its key: after
    a step, the updated rows of shard 0 and shard 1 hold the same number
    (one key for both). The port: the same update on shard 0 and shard 1
    hands K3 two different seeds and writes different params."""
    bf16 = dict(TASK, table_dtype=jnp.bfloat16, stochastic_rounding=True)

    def keyed_fill(x, key):
        return jnp.full(x.shape, jax.random.uniform(key, (), minval=1.0,
                                                    maxval=2.0), jnp.bfloat16)
    monkeypatch.setattr(jrounding, "stochastic_round_bf16", keyed_fill)
    jt = jax_trainer("sharded", task=bf16)
    data = JaxSyntheticCTR(num_users=60, num_items=40, batch_size=B,
                           seed=SEED)
    jt.train_step(*data.batch(), ts=0)
    params = np.asarray(jt.table_states["sparse"]["params"], np.float32)
    live = [np.unique(params[s][params[s].any(axis=1)]) for s in range(S)]
    assert all(len(v) == 1 for v in live), live    # one fill per shard
    assert live[0][0] == live[1][0]                # ... and the same one

    # the port: two shards' engines, the same rows and gradients
    ptask = DeepFMTask(**dict(TASK, table_dtype=torch.bfloat16,
                              stochastic_rounding=True))
    seeds, outs = [], []
    real = ptable.stochastic_round_bf16

    def recorded(x, seed):
        seeds.append(seed)
        return real(x, seed)
    monkeypatch.setattr(ptable, "stochastic_round_bf16", recorded)
    rows = torch.arange(32, dtype=torch.int32)
    grads = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 9)).astype(np.float32) * 1e-3)
    for shard in range(S):
        eng = EmbeddingEngine(ptask.tables(), ptask.features(), EngineConfig(
            num_shards=S, packed="off", local_shards=(shard,)),
            device="cpu")
        assert eng.shard == shard
        states = eng.create_states()
        states["sparse"]["params"][:32] = 0.5
        eng.apply_gradients(states, {"sparse": {"rows": rows}},
                            {"sparse": grads}, step=3, seed=SEED)
        outs.append(states["sparse"]["params"][:32].clone())
    assert seeds == [_round_seed(SEED, 3, 0, 0), _round_seed(SEED, 3, 0, 1)]
    assert seeds[0] != seeds[1]
    assert not torch.equal(outs[0], outs[1])

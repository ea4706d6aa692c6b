"""Rank process of the port's multi-host trainer tests
(tests/test_torch_multihost.py).

    python tests/torch_multihost_worker.py JOB RANK WORLD PORT OUT

joins a gloo group of WORLD ranks at tcp://localhost:PORT (the launcher
and `main` are tests/torch_sharded_worker.py's), runs the job pickled in
JOB (MultiHostTrainer runs on the CPU, rank r fed rows [r*b, (r+1)*b) of
each global batch) and pickles this rank's results into OUT. It imports
the port and torch, never JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from torch_sharded_worker import _hash, _np, _same_on_every_rank, main


def local(pair, rank: int, world: int):
    """Rank `rank`'s rows of a global (fid_batch, batch)."""
    fb, b = pair
    n = len(next(iter(b.values()))) // world
    sl = slice(rank * n, (rank + 1) * n)
    return ({k: v[sl] for k, v in fb.items()},
            {k: v[sl] for k, v in b.items()})


def make(job, mesh, task=None, **engine):
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import MultiHostTrainer
    from monolith_tpu_torch.training.trainer import TrainerConfig
    cfg = TrainerConfig(engine=EngineConfig(**dict(job["engine"], **engine)),
                        log_every=0, seed=job["seed"])
    return MultiHostTrainer(DeepFMTask(**(task or job["task"])), cfg, mesh)


def snapshot(tr):
    """The rank's pool (f32), its own store's dump, the dense state."""
    from monolith_tpu_torch import convert
    st = convert.export_state(tr)
    return {"pool": {t: p[0] for t, p in st["tables"].items()},
            "stores": {t: s[tr.mesh.rank] for t, s in st["stores"].items()},
            "params": st["params"], "opt_state": st["opt_state"],
            "step": st["step"]}


def record_host(tr):
    """Record every local prepare's wire and every owner map's received
    ids and arrays."""
    rec = {"wire": [], "map": []}
    prepare, map_ids = tr._prepare_local, tr._map_ids

    def prepare_spy(fb):
        out = prepare(fb)
        rec["wire"].append(out[0].copy())
        return out

    def map_spy(recv, ts, train=True):
        out = map_ids(recv, ts, train)
        if train:
            rec["map"].append((recv.copy(), out[0], out[1], out[2]))
        return out
    tr._prepare_local, tr._map_ids = prepare_spy, map_spy
    return rec


class PushTo:
    """A stand-in sync target: keeps every push."""

    def __init__(self):
        self.pushes = []

    def push(self, table, fids, values):
        self.pushes.append((table, np.array(fids), np.array(values)))
        return [len(fids)]


def main_scenario(job, mesh):
    """From the carried state: steps, a synchronous block, evaluate, the
    spill, a block that revives, a step, expiry, predict, export, a
    checkpoint, a streaming round; then the asynchronous block."""
    import torch
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.serving import codec
    from monolith_tpu_torch.serving.export import export_model
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.controller import TrainingController
    from monolith_tpu_torch.training.streaming import StreamingTrainer
    r, S = mesh.rank, mesh.size
    pairs = [local(p, r, S) for p in job["pairs"]]
    post = [local(p, r, S) for p in job["post"]]
    evals = [local(p, r, S) for p in job["evals"]]
    n, K, ts0 = job["steps"], job["K"], job["ts0"]
    res = {"rank": r}

    tr = make(job, mesh)
    convert.load_state(tr, job["state0"])
    res["held"] = {t: [s is not None for s in st]
                   for t, st in tr.engine.shard_stores.items()}
    host = record_host(tr)
    res["steps"] = []
    for i in range(n):
        out = tr.train_step(*pairs[i], ts=ts0 + i)
        res["steps"].append({"loss": float(out["loss"]),
                             "preds": _np(out["preds"]),
                             "stats": out["stats"]})
    res["after_steps"] = snapshot(tr)
    out = tr.train_step_block(pairs[n:n + K], ts=ts0 + n)
    res["block"] = {"loss": _np(out["loss"]), "preds": _np(out["preds"]),
                    "stats": out["stats"]}
    res["after_block"] = snapshot(tr)
    res["host"] = host
    res["eval"] = tr.evaluate(iter(evals))
    _same_on_every_rank(res["eval"], "evaluate")
    res["spilled"] = tr.spill_expired(job["spill_before"])
    res["archives"] = convert.export_archives(tr)
    staged = tr.stage_block(post, ts=job["post_ts"])
    out = tr.train_step_block(post, staged=staged)
    res["post"] = {"loss": _np(out["loss"]),
                   "revived": {t: tr.engine.archive_of(t).revived
                               for t in tr.engine.shard_archives}}
    res["after_post"] = snapshot(tr)
    res["last"] = float(tr.train_step(*local(job["last"], r, S),
                                      ts=job["last_ts"])["loss"])
    res["freed"] = tr.evict_expired(job["evict_before"])
    res["final"] = snapshot(tr)
    _same_on_every_rank(_hash(res["final"]["params"]), "params")
    res["predict"] = _np(tr.predict(*evals[0]))
    export_model(tr, job["export_dir"])
    checkpoint.save(tr, job["ckpt_dir"])
    sync = PushTo()
    res["pushed"] = StreamingTrainer(tr, sync).sync_now()
    rows = {}
    for t, fids, values in sync.pushes:
        got = tr.engine.store_of(t).lookup(fids)
        pool = tr.table_states[t]["data"].float()
        want = pool[torch.from_numpy(got).long(), :values.shape[1]].numpy()
        rows[t] = (fids, values, np.array_equal(values, want))
    res["pushes"] = rows
    res["touched_left"] = {t: s.touched_size()
                           for t, st in tr.engine.shard_stores.items()
                           for s in st if s is not None}
    status = codec.unpack(TrainingController(tr)._rpc_status(None, None))
    res["status"] = {k: int(v) for k, v in status.items()
                     if k.startswith("table:")}

    # the 1-step-stale asynchronous block from the same state
    tra = make(job, mesh, async_optimize=True)
    convert.load_state(tra, job["state0"])
    out = tra.train_step_block(pairs[:K], ts=ts0)
    res["async"] = {"loss": _np(out["loss"]), "preds": _np(out["preds"]),
                    "after": snapshot(tra)}
    return res


def admission_scenario(job, mesh):
    """A threshold-2 (sliding filter) table, restored from the JAX
    package's checkpoint (filters included), then steps."""
    from monolith_tpu_torch.training import checkpoint
    r, S = mesh.rank, mesh.size
    a = job["admission"]
    tr = make(job, mesh, task=a["task"])
    step = checkpoint.restore(tr, a["jax_ckpt"])
    res = {"restored_step": step, "steps": []}
    for i, pair in enumerate(a["pairs"]):
        out = tr.train_step(*local(pair, r, S), ts=1 + i)
        res["steps"].append({"loss": float(out["loss"]),
                             "stats": out["stats"]})
    res["after"] = snapshot(tr)
    return res


def sharded_scenario(job, mesh):
    """The ShardedTrainer's checkpoint per shard (every rank holds every
    store): saved after 2 steps, restored into a fresh ShardedTrainer and
    into a MultiHostTrainer of the same S; and a single-device Trainer's
    checkpoint restored 1 -> S."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import ShardedTrainer
    from monolith_tpu_torch.training import checkpoint
    from monolith_tpu_torch.training.trainer import TrainerConfig
    engine = dict(job["engine"], tiered=False, exchange="a2a")

    def sharded():
        return ShardedTrainer(DeepFMTask(**job["task"]), TrainerConfig(
            engine=EngineConfig(**engine), log_every=0, seed=job["seed"]),
            mesh)
    tr = sharded()
    convert.load_state(tr, job["state0"])
    for i, pair in enumerate(job["pairs"][:2]):
        tr.train_step(*pair, ts=1 + i)
    path = checkpoint.save(tr, job["sharded_dir"])
    back = sharded()
    step = checkpoint.restore(back, job["sharded_dir"])
    mh = make(job, mesh, tiered=False)
    checkpoint.restore(mh, job["sharded_dir"])
    single = make(job, mesh, tiered=False)
    checkpoint.restore(single, job["single_dir"])
    return {"files": sorted(os.listdir(os.path.join(path, "tables"))),
            "step": step, "saved": convert.export_state(tr),
            "restored": convert.export_state(back),
            "multihost": snapshot(mh), "from_single": snapshot(single)}


def reshard_scenario(job, mesh):
    """A checkpoint of another shard count restored into S ranks."""
    from monolith_tpu_torch.training import checkpoint
    tr = make(job, mesh)
    res = {"step": checkpoint.restore(tr, job["reshard_from"])}
    res["after"] = snapshot(tr)
    return res


def estimator_scenario(job, mesh):
    """train -> save -> a second Estimator resumes (each rank feeds its own
    rows)."""
    from monolith_tpu_torch.estimator import Estimator, RunnerConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import MultiHostTrainer
    r, S = mesh.rank, mesh.size
    pairs = [local(p, r, S) for p in job["pairs"]]
    cfg = RunnerConfig(model_dir=job["estimator_dir"], seed=job["seed"],
                       unique_cap=job["engine"]["unique_cap"],
                       new_cap=job["engine"]["new_cap"], log_every=0)
    est = Estimator(DeepFMTask(**job["task"]), cfg, device="cpu")
    res = {"multihost": isinstance(est.trainer, MultiHostTrainer),
           "shards": est.trainer.engine.config.num_shards}
    est.train(iter(pairs[:3]))
    res["first"] = est.trainer.step
    saved = snapshot(est.trainer)
    est2 = Estimator(DeepFMTask(**job["task"]), cfg, device="cpu")
    est2._maybe_restore()
    restored = snapshot(est2.trainer)
    res["restored_equal"] = (_hash(restored) == _hash(saved))
    est2.train(iter(pairs[3:5]))
    res["second"] = est2.trainer.step
    return res


def census_scenario(job, mesh):
    """all_to_all_single calls and their dtypes in one train_step of small
    multislot models: f32 with 1 and 3 tables, and bf16."""
    import torch.distributed as dist
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.multislot import MultiSlotTask
    from monolith_tpu_torch.parallel import MultiHostTrainer
    from monolith_tpu_torch.training.trainer import TrainerConfig
    import torch
    r, S = mesh.rank, mesh.size
    out = {}
    real = dist.all_to_all_single
    for name, kw in (("f32_1", dict(num_tables=1)),
                     ("f32_3", dict(num_tables=3)),
                     ("bf16_3", dict(num_tables=3,
                                     table_dtype=torch.bfloat16,
                                     stochastic_rounding=True))):
        task = MultiSlotTask(num_slots=4, embedding_dim=8,
                             capacity_per_shard=1024, history_length=6,
                             hidden=(16,), merge=False, **kw)
        tr = MultiHostTrainer(task, TrainerConfig(engine=EngineConfig(
            num_shards=S, unique_cap=256, new_cap=256, bucket_cap=64),
            log_every=0), mesh)
        data = SyntheticMultiSlot(num_slots=4, vocab_per_slot=60,
                                  history_length=6, batch_size=64, seed=7)
        tr.train_step(*local(data.batch(), r, S), ts=0)
        calls = []

        def spy(output, input, *a, **k):
            calls.append(str(input.dtype))
            return real(output, input, *a, **k)
        dist.all_to_all_single = spy
        try:
            loss = float(tr.train_step(*local(data.batch(), r, S),
                                       ts=1)["loss"])
        finally:
            dist.all_to_all_single = real
        out[name] = {"tables": len(task.tables()), "calls": calls,
                     "loss": loss}
    return out


def scenario(job, mesh):
    res = {}
    if job.get("state0") is not None:
        res["main"] = main_scenario(job, mesh)
    for key, run in (("sharded_dir", sharded_scenario),
                     ("admission", admission_scenario),
                     ("reshard_from", reshard_scenario),
                     ("estimator_dir", estimator_scenario),
                     ("census", census_scenario)):
        if job.get(key):
            res[key] = run(job, mesh)
    return res


if __name__ == "__main__":
    main(sys.argv[1:], scenario)

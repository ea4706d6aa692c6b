"""Rank process of the structure-of-arrays sharded tests
(tests/test_torch_soa_sharded.py).

    python tests/torch_soa_worker.py JOB RANK WORLD PORT OUT

joins a gloo group of WORLD ranks at tcp://localhost:PORT (the launcher
and `main` are tests/torch_sharded_worker.py's), loads the carried JAX
state into a ShardedTrainer or a MultiHostTrainer (job["kind"]) with
`EngineConfig(packed="off")`, runs its steps and pickles this rank's
results into OUT. It imports the port and torch, never JAX.
"""

from __future__ import annotations

import sys

from torch_multihost_worker import local
from torch_sharded_worker import _np, main


def soa_scenario(job, mesh):
    """Per-step steps, then a synchronous block of K (the sharded
    trainer's block steps synchronously on this layout) or more steps
    (the multi-host trainer), then an evaluation; the rank's table state
    after each stage."""
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import MultiHostTrainer, ShardedTrainer
    from monolith_tpu_torch.training.trainer import TrainerConfig
    r, S = mesh.rank, mesh.size
    multihost = job["kind"] == "multihost"
    cls = MultiHostTrainer if multihost else ShardedTrainer
    tr = cls(DeepFMTask(**job["task"]), TrainerConfig(
        engine=EngineConfig(**job["engine"]), log_every=0,
        seed=job["seed"]), mesh)
    convert.load_state(tr, job["state0"])
    feed = [local(p, r, S) if multihost else p for p in job["pairs"]]
    n, K, ts0 = job["steps"], job["K"], job["ts0"]
    res = {"rank": r, "steps": []}
    for i in range(n):
        out = tr.train_step(*feed[i], ts=ts0 + i)
        res["steps"].append({"loss": float(out["loss"]),
                             "preds": _np(out["preds"])})
    res["after_steps"] = convert.export_state(tr)["tables"]
    out = tr.train_step_block(feed[n:n + K], ts=ts0 + n)
    res["block"] = {"loss": _np(out["loss"]), "preds": _np(out["preds"])}
    res["after_block"] = convert.export_state(tr)["tables"]
    evals = [local(p, r, S) if multihost else p for p in job["evals"]]
    res["eval"] = tr.evaluate(iter(evals))
    return res


if __name__ == "__main__":
    main(sys.argv[1:], run=soa_scenario)

"""Rank process of the port's tiered sharded-trainer tests
(tests/test_torch_sharded_tiered.py).

    python tests/torch_sharded_tiered_worker.py JOB RANK WORLD PORT OUT

joins a gloo group of WORLD ranks at tcp://localhost:PORT (the launcher
and `main` are tests/torch_sharded_worker.py's), runs the job pickled in
JOB (a tiered ShardedTrainer from a carried JAX state and its archives:
steps that revive, a spill, steps and a block that revive, a checkpoint,
deltas both ways) and pickles this rank's results into OUT. It imports
the port and torch, never JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from torch_sharded_worker import _hash, _np, _same_on_every_rank, main


def make(job, mesh, **engine):
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import ShardedTrainer
    from monolith_tpu_torch.training.trainer import TrainerConfig
    cfg = TrainerConfig(engine=EngineConfig(**dict(job["engine"], **engine)),
                        log_every=0, seed=job["seed"])
    return ShardedTrainer(DeepFMTask(**job["task"]), cfg, mesh)


def carried(job, mesh, state, archives):
    """A tiered trainer loaded with a state and rank r's archives."""
    from monolith_tpu_torch import convert
    tr = make(job, mesh)
    convert.load_state(tr, state)
    convert.load_archives({t: tr.engine.archive_of(t)
                           for t in tr.engine.shard_archives},
                          archives[mesh.rank])
    return tr


def snapshot(tr):
    """The rank's pool (f32), every store it holds, its own archive and
    the dense state."""
    from monolith_tpu_torch import convert
    st = convert.export_state(tr)
    return {"pool": {t: p[0] for t, p in st["tables"].items()},
            "stores": st["stores"], "archives": convert.export_archives(tr),
            "params": st["params"], "opt_state": st["opt_state"],
            "step": st["step"]}


def watch_revives(tr, width):
    """Check, at every lookup of a step that revives, that each revived
    row handed to the model equals its archived state bit for bit (the
    values the prepare took out of the archive); count the rows."""
    seen = {"rows": 0, "values": []}
    lookup = tr.engine.fused_lookup

    def spy(states, inputs, seed, step):
        prows, unique = lookup(states, inputs, seed, step)
        for t, tin in inputs.items():
            pos = tin.get("revive_pos")
            if pos is None or not len(pos):
                continue
            n = int((pos >= 0).sum())
            got = prows[t][pos[:n].long(), :width].numpy()
            want = tin["revive_values"][:n].numpy()
            assert np.array_equal(got, want), "a revived row differs"
            seen["rows"] += n
            seen["values"].append(want.copy())
        return prows, unique
    tr.engine.fused_lookup = spy
    return seen


def stores_hash(stores) -> str:
    """A hash of every shard's store dump (fids, rows, tss, counts)."""
    return _hash({t: {str(s): dict(enumerate(dump))
                      for s, dump in enumerate(dumps)}
                  for t, dumps in stores.items()})


def archive_rows(tr) -> dict:
    """{fid: archived row} of the rank's own archive."""
    from monolith_tpu_torch import convert
    a = convert.export_archives(tr)["sparse"]
    return {int(f): v for f, v in zip(a["fids"], a["values"])}


def rows_by_id(tr, fids) -> np.ndarray:
    """The params of `fids` in this rank's own shard (NaN where absent)."""
    from monolith_tpu_torch import convert
    st = convert.export_state(tr)
    store = tr.engine.store_of("sparse")
    rows = store.lookup(np.asarray(fids, np.int64))
    pool = st["tables"]["sparse"][0]
    dim = tr.engine.tables["sparse"].dim
    out = np.full((len(fids), dim), np.nan, np.float32)
    out[rows >= 0] = pool[rows[rows >= 0], :dim]
    return out


def scenario(job, mesh):
    from monolith_tpu_torch import convert
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.embedding.tiered import state_width
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.parallel import MultiHostTrainer
    from monolith_tpu_torch.training import checkpoint as ckpt
    from monolith_tpu_torch.training.trainer import TrainerConfig
    r = mesh.rank
    res = {"rank": r}
    tr = carried(job, mesh, job["state0"], job["archives0"])
    width = state_width(tr.engine.tables["sparse"])
    seen = watch_revives(tr, width)
    before = archive_rows(tr)
    res["steps"] = []
    for i, pair in enumerate(job["pairs"]):
        out = tr.train_step(*pair, ts=job["ts0"] + i)
        res["steps"].append({"loss": float(out["loss"]),
                             "preds": _np(out["preds"]),
                             "stats": out["stats"]})
    res["revived_steps"] = tr.engine.archive_of("sparse").revived
    res["after_steps"] = snapshot(tr)
    res["spilled"] = tr.spill_expired(job["spill_before"])
    res["after_spill"] = snapshot(tr)
    mid_state = convert.export_state(tr)
    before.update(archive_rows(tr))
    res["post"] = []
    for i, pair in enumerate(job["post"]):
        out = tr.train_step(*pair, ts=job["post_ts"] + i)
        res["post"].append({"loss": float(out["loss"]),
                            "preds": _np(out["preds"]),
                            "stats": out["stats"]})
    res["after_post"] = snapshot(tr)
    res["revived"] = tr.engine.archive_of("sparse").revived
    res["revived_seen"] = seen["rows"]
    # every revived row is one the archive held before, exactly
    held = {v.tobytes() for v in before.values()}
    res["revived_from_archive"] = all(
        row.tobytes() in held for vals in seen["values"] for row in vals)
    _same_on_every_rank(stores_hash(res["after_post"]["stores"]), "stores")
    _same_on_every_rank(_hash(res["after_post"]["params"]), "dense params")

    # a block that revives = the same batches as steps, bit for bit
    twins = {}
    for kind in ("steps", "block"):
        twin = carried(job, mesh, mid_state,
                       {r: res["after_spill"]["archives"]})
        if kind == "block":
            out = twin.train_step_block(job["post"], ts=job["post_ts"])
            losses = _np(out["loss"])
        else:
            losses = np.array([float(twin.train_step(
                *p, ts=job["post_ts"])["loss"]) for p in job["post"]])
        twins[kind] = dict(snapshot(twin), losses=losses,
                           revived=twin.engine.archive_of("sparse").revived)
    res["twins"] = twins

    # the checkpoint keeps the archive (every rank saves its own)
    if job.get("ckpt_dir"):
        # spill the ids of the first post steps, so that the archives
        # hold rows
        res["spilled_before_ckpt"] = tr.spill_expired(job["post_ts"] + 2)
        res["before_ckpt"] = snapshot(tr)
        ckpt.save(tr, job["ckpt_dir"])
        back = make(job, mesh)
        ckpt.restore(back, job["ckpt_dir"])
        res["restored"] = snapshot(back)
        res["archive_files"] = sorted(os.listdir(os.path.join(
            job["ckpt_dir"], f"ckpt-{tr.step}", "archives")))

    # deltas: this rank's shard file; the JAX delta restored here
    res["port_delta"] = ckpt.save_delta(tr, job["port_delta_dir"],
                                        since_ts=job["post_ts"])
    rd = make(job, mesh)
    res["jax_delta_applied"] = ckpt.restore_delta(rd, job["jax_delta"])
    res["jax_delta_step"] = rd.step
    z = np.load(os.path.join(job["jax_delta"], f"sparse-s{r}.npz"))
    res["jax_delta_rows"] = rows_by_id(rd, z["fids"])
    res["jax_delta_stores"] = stores_hash(snapshot(rd)["stores"])
    _same_on_every_rank(res["jax_delta_stores"], "stores after the delta")
    try:
        ckpt.restore_delta(rd, job["single_delta"])
        res["mismatch_raised"] = False
    except ValueError as e:
        res["mismatch_raised"] = "shards" in str(e)
    mh = MultiHostTrainer(DeepFMTask(**job["task"]), TrainerConfig(
        engine=EngineConfig(**dict(job["engine"], tiered=False)),
        log_every=0), mesh)
    try:
        ckpt.save_delta(mh, job["port_delta_dir"] + "-mh", since_ts=0)
        res["multihost_delta_raised"] = False
    except ValueError as e:
        res["multihost_delta_raised"] = "multi-host" in str(e)
    return res


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(sys.argv[1:], run=scenario)

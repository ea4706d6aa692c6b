"""Training cells whose rows are a vector alone, with the program's own
spans: `train_replay`'s set-up, window and traced record, run by import,
with this module's trainer (per-table unique caps), state reading (the
vector's accumulator is segment 0's) and comparison (`compare_vectors`,
the reference's own `run`).

With `--trace 1` a `tracing.recording()` of the program is open for the
whole run, so that its spans (and its `mt.` ranges in the profiler
window) and counters cover the window; the record gains "program" (the
spans and counters of the window's unprofiled part, the stage worker's
thread apart), "under" (device seconds of the kernels under
`mt.step.cross` and `mt.step.pool` in the profiler window) and
"cross_flops_per_step". The profiler window's busy time and operation
count leave out the program's ranges as they leave out the benchmark's.
Untraced runs open no recording.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import numpy as np

from portbench import compare_vectors, program_trace
from portbench.drivers import train_replay
from portbench.reference import common

_host = train_replay._host


def build(ctx):
    """One trainer on the device, its dense weights the benchmark's; the
    run stops before any pool is made if the program would not step the
    configuration in blocks on the fused wire."""
    from monolith_tpu_torch.embedding.engine import (EmbeddingEngine,
                                                     EngineConfig)
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    cfg = ctx.cfg
    task = ctx.program.build_task(cfg)
    if task.dense_optimizer().learning_rate != cfg["dense_learning_rate"]:
        raise ValueError("the task's dense learning rate is not the "
                         "configuration's")
    caps = tuple(sorted(cfg["unique_caps"].items()))
    engine = EngineConfig(num_shards=1, unique_cap=max(dict(caps).values()),
                          new_cap=max(dict(caps).values()), unique_caps=caps,
                          new_caps=caps)
    probe = [dataclasses.replace(t, capacity_per_shard=1)
             for t in task.tables()]
    if not EmbeddingEngine(probe, task.features(), engine,
                           device="cpu").fuse_wire:
        raise RuntimeError("the program's engine does not take the fused "
                           "wire at these unique caps: no blocks")
    trainer = Trainer(task, TrainerConfig(
        engine=engine, seed=ctx.seed, log_every=0,
        steps_per_dispatch=cfg["steps_per_dispatch"]), device=ctx.device)
    dense0 = common.dense_weights(ctx.reference.param_shapes(cfg), ctx.seed,
                                  ctx.device)
    train_replay.load_dense(trainer, dense0)
    return trainer, dense0


def read_state(trainer, tables: Dict[str, list], batches) -> Dict:
    """The program's state as the comparison reads it: dense parameters
    and their accumulators by name, and per table the vector and its
    Adagrad accumulator of every id of `batches`, through the trainer's
    own id -> row map."""
    import torch
    from monolith_tpu_torch.embedding import table as table_lib
    dense = {n: (_host(p), _host(trainer.opt_state[n]))
             for n, p in trainer.module.named_parameters()}
    rows = {}
    for t, feats in tables.items():
        fids = train_replay._table_ids(batches, feats)
        spec, state = trainer.engine.tables[t], trainer.table_states[t]
        r = torch.from_numpy(trainer.engine.store_of(t).lookup(fids)
                             .astype(np.int64)).to(trainer.device)
        ok = (r >= 0)[:, None]

        def take(view):
            got = view.index_select(0, r.clamp(min=0)).float()
            return _host(torch.where(ok, got, torch.zeros_like(got)))
        rows[t] = (fids, take(table_lib.params_view(spec, state)),
                   take(table_lib.slot_view(spec, state, 0, "norm")))
    return {"dense": dense, "rows": rows}


def check(ctx, batches, dense0, observed, tf32=False, fault=None,
          detail=None):
    """The reference over the first block, and the numbers compared."""
    K = ctx.cfg["steps_per_dispatch"]
    ref = ctx.reference.run(ctx.cfg, batches[:K], dense0, ctx.seed,
                            ctx.device, steps=K, tf32=tf32, fault=fault)
    return ref, compare_vectors.train_readings(
        observed, ref, {k: _host(v) for k, v in dense0.items()}, ctx.cfg,
        detail)


def _traced(ctx, st, spans, batches, t0, step0) -> Dict:
    out = _TRACED(ctx, st, spans, batches, t0, step0)
    rec = out["record"]
    summary = program_trace.summarize(st["prof"])
    if summary is not None:
        rec["prof"] = dict(summary, steps=st["step1"] - st["step0"])
        out["busy_s"] = summary["busy_s"]
        out["breakdown"] = {"device_ops": summary["top_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    rec["under"] = {n: program_trace.kernel_seconds_under(st["prof"], n)
                    for n in ("mt.step.cross", "mt.step.pool")}
    rec["cross_flops_per_step"] = (ctx.cfg["batch_size"] * ctx.reference
                                   .cross_flops_per_example(ctx.cfg))
    from monolith_tpu_torch.utils import tracing
    rec["program"] = program_trace.window(tracing.active(), t0, st["t0"])
    ctx.log(f"program spans of the unprofiled window: {rec['program']}; "
            f"kernel seconds under spans in the profiler window: "
            f"{rec['under']}")
    return out


_TRACED = train_replay._traced


@contextlib.contextmanager
def _train_replay_with_ours():
    """train_replay's run with this module's trainer, state reading,
    comparison and traced record; restored after."""
    ours = {"build": build, "read_state": read_state, "check": check,
            "_traced": _traced}
    saved = {k: getattr(train_replay, k) for k in ours}
    for k, v in ours.items():
        setattr(train_replay, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(train_replay, k, v)


def run(ctx) -> Dict:
    from monolith_tpu_torch.utils import tracing
    with _train_replay_with_ours():
        if not ctx.trace:
            return train_replay.run(ctx)
        with tracing.recording():
            return train_replay.run(ctx)

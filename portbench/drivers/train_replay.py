"""Training cells: `Trainer.train` of monolith_tpu_torch over a replayed
pool of batches, in blocks of `steps_per_dispatch` (`_train_blocked`:
`stage_block` one block ahead, `train_step_block`).

Set-up builds ONE trainer, loads the benchmark's dense weights into it,
makes the pool of batches from the seed, and drives the trainer through
its first block by `Trainer.train` (the first `steps_per_dispatch`
batches: one staged `train_step_block`, the window's own call), keeping
the block's losses and predictions and reading its state after the block
for the comparison; then one warm-up pass over the rest of the pool
admits every id. The window
hands the same trainer the pool in order, again and again, through
`Trainer.train(data, steps=None, hooks=(stop,))`, where `stop` asks for a
clean stop once `--seconds` have passed; it ends with a synchronise.

With `--trace 1` the trainer instance's `stage_block` and
`train_step_block`, the feed and the hooks are timed as spans, and a
torch.profiler window of `trace_blocks` blocks opens once
`trace_start_share` of the window has passed (the card synchronised at
its start and its end): the unprofiled part before it gives the host's
ms per step.
"""

from __future__ import annotations

import gc
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, flops, trace
from portbench.reference import common
from portbench.reference import train as reference_train


def make_batches(world, n: int, batch_size: int, threads: int) -> List:
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(lambda i: world.batch(i, batch_size), range(n)))


def host_info() -> str:
    """Threads and load of the host, for the record."""
    from monolith_tpu_torch.embedding.host_store import host_threads
    with open("/proc/loadavg") as f:
        load = f.read().split()[:3]
    return (f"{len(os.sched_getaffinity(0))} cores, torch threads "
            f"{torch.get_num_threads()}, host pool threads "
            f"{host_threads()}, load {load}")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def _table_ids(batches, features) -> np.ndarray:
    ids = np.unique(np.concatenate([np.ascontiguousarray(fb[f]).ravel()
                                    for fb, _ in batches for f in features]))
    return ids[ids != -1]


def read_state(trainer, tables: Dict[str, list], batches) -> Dict:
    """The program's state as the comparison reads it: dense parameters
    and their Adagrad accumulators by name, and per table the bias and
    vector (params) and the vector's accumulator of every id of `batches`,
    read through the trainer's own id -> row map."""
    from monolith_tpu_torch.embedding import table as table_lib
    dense = {n: (_host(p), _host(trainer.opt_state[n]))
             for n, p in trainer.module.named_parameters()}
    rows = {}
    for t, feats in tables.items():
        fids = _table_ids(batches, feats)
        pt = trainer.engine.features[feats[0]].table
        spec, state = trainer.engine.tables[pt], trainer.table_states[pt]
        r = torch.from_numpy(trainer.engine.store_of(pt).lookup(fids)
                             .astype(np.int64)).to(trainer.device)
        ok = (r >= 0)[:, None]

        def take(view):
            got = view.index_select(0, r.clamp(min=0)).float()
            return _host(torch.where(ok, got, torch.zeros_like(got)))
        rows[t] = (fids, take(table_lib.params_view(spec, state)),
                   take(table_lib.slot_view(spec, state, 1, "norm")))
    return {"dense": dense, "rows": rows}


def load_dense(trainer, dense0: Dict[str, torch.Tensor]) -> None:
    named = dict(trainer.module.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    if shapes != {n: tuple(w.shape) for n, w in dense0.items()}:
        raise ValueError(f"the program's dense parameters {shapes} are not "
                         f"the configuration's")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(dense0[n])


def build(ctx):
    """One trainer on the device, its dense weights the benchmark's."""
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
    cfg = ctx.cfg
    task = ctx.program.build_task(cfg)
    if task.dense_optimizer().learning_rate != cfg["dense_learning_rate"]:
        raise ValueError("the task's dense learning rate is not the "
                         "configuration's")
    trainer = Trainer(task, TrainerConfig(
        engine=EngineConfig(num_shards=1, unique_cap=cfg["unique_cap"],
                            new_cap=cfg["new_cap"]),
        seed=ctx.seed, log_every=0,
        steps_per_dispatch=cfg["steps_per_dispatch"]), device=ctx.device)
    dense0 = common.dense_weights(ctx.reference.param_shapes(cfg), ctx.seed,
                                  ctx.device)
    load_dense(trainer, dense0)
    return trainer, dense0


def first_block(ctx, trainer, batches) -> Dict:
    """The first block through `Trainer.train`, as the window runs its
    blocks; returns what the comparison reads."""
    K = ctx.cfg["steps_per_dispatch"]
    losses: List[float] = []
    preds: List[np.ndarray] = []

    def keep(_, out):
        losses.extend(out["loss"].reshape(-1).tolist())
        p = _host(out["preds"])
        preds.extend(p.reshape(-1, p.shape[-1]))
    calls = []
    trainer.train(iter(batches[:K]), steps=K,
                  hooks=(keep, lambda *_: calls.append(1)))
    if len(calls) != 1 or len(losses) != K:
        raise RuntimeError(f"the first {K} steps fired the hooks "
                           f"{len(calls)} times with {len(losses)} losses: "
                           f"they did not run as one block")
    return dict(read_state(trainer, ctx.reference.tables(ctx.cfg),
                           batches[:K]), losses=losses, preds=preds)


def check(ctx, batches, dense0, observed, tf32=False, fault=None,
          detail=None) -> Dict:
    """The reference over the first block, and the numbers compared."""
    K = ctx.cfg["steps_per_dispatch"]
    ref = reference_train.run(ctx.reference, ctx.cfg, batches[:K], dense0,
                              ctx.seed, ctx.device, steps=K, tf32=tf32,
                              fault=fault)
    return ref, compare.train_readings(
        observed, ref, {k: _host(v) for k, v in dense0.items()}, ctx.cfg,
        detail)


def run(ctx) -> Dict:
    from monolith_tpu_torch.ops import scatter
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    B, K = cfg["batch_size"], cfg["steps_per_dispatch"]
    trainer, dense0 = build(ctx)
    world = ctx.stream.World(cfg, ctx.seed)
    batches = make_batches(world, tr["batches"], B, tr["generator_threads"])
    observed = first_block(ctx, trainer, batches)
    trainer.train(iter(batches[K:]), steps=len(batches) - K)
    trace.sync(dev)

    spans = trace.Spans()
    last = {}
    prof_state = {"prof": None, "t0": None, "t1": None, "step0": 0,
                  "step1": 0, "blocks": 0}

    data = itertools.cycle(batches)
    hooks = []
    if ctx.trace:
        for name, attr in (("stage", "stage_block"),
                           ("dispatch", "train_step_block")):
            setattr(trainer, attr, spans.wrap(name, getattr(trainer, attr)))
        get = spans.wrap("data", lambda it: next(it))

        def traced_feed(it):
            while True:
                yield get(it)
        data = traced_feed(data)

        def profile(tr_, out):
            st = prof_state
            if st["t0"] is None and time.perf_counter() - t0 >= \
                    tr["trace_start_share"] * ctx.seconds:
                trace.sync(dev)
                st["prof"] = trace.profiler(dev)
                st["t0"], st["step0"] = time.perf_counter(), tr_.step
                st["prof"].start()
            elif st["t0"] is not None and st["t1"] is None:
                st["blocks"] += 1
                if st["blocks"] == tr["trace_blocks"]:
                    _stop(st, tr_, dev)
        hooks.append(spans.wrap("hook", profile))

    marks = []

    def stop(_, out):
        last["out"] = out
        marks.append(time.perf_counter())
        profiling = prof_state["t0"] is not None and prof_state["t1"] is None
        if time.perf_counter() >= t_end and not profiling:
            raise StopIteration
    hooks.append(spans.wrap("hook", stop) if ctx.trace else stop)

    if ctx.trace:
        trace.warm_profiler(dev)
    launches0 = (scatter.gather_rows.launches, scatter.scatter_rows.launches)
    step0 = trainer.step
    trace.sync(dev)
    wall0, t0 = time.time(), time.perf_counter()
    t_end = t0 + ctx.seconds
    trainer.train(data, steps=None, hooks=tuple(hooks))
    trace.sync(dev)
    t1 = time.perf_counter()
    if prof_state["prof"] is not None and prof_state["t1"] is None:
        _stop(prof_state, trainer, dev)
    steps = trainer.step - step0
    rate = steps * B / (t1 - t0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stats = last["out"]["stats"][-1]
    per_block = np.diff([t0] + marks) / K * 1e3
    third = max(1, len(per_block) // 3)
    ctx.log(f"host: {host_info()}; ms per step by block (dispatch to "
            f"dispatch) min/q1/median/q3/max "
            f"{np.percentile(per_block, [0, 25, 50, 75, 100]).tolist()}, "
            f"first third {np.mean(per_block[:third])}, last third "
            f"{np.mean(per_block[-third:])}")
    ctx.log(f"window: {steps} steps in {t1 - t0:.6f} s, "
            f"{steps // K} blocks of {K}; K1 launches per step "
            f"{(scatter.gather_rows.launches - launches0[0]) / steps}, K2 "
            f"{(scatter.scatter_rows.launches - launches0[1]) / steps}; "
            f"the program's count in the last step: unique ids "
            f"{stats['unique']}, admitted {stats['new']}, over the cap "
            f"{stats['overflow']}")

    out = {"e2e": {"train_examples_per_s": rate}, "wall_window_start": wall0,
           "attempted": steps, "failed": 0, "memory_peak_bytes": peak}
    if ctx.trace:
        out.update(_traced(ctx, prof_state, spans, batches, t0, step0))
    del trainer, last
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    _, out["readings"] = check(ctx, batches, dense0, observed)
    ctx.log(f"reference: {K} steps followed and compared in "
            f"{time.perf_counter() - t_ref:.3f} s")
    return out


def _stop(st, trainer, dev) -> None:
    trace.sync(dev)
    st["t1"], st["step1"] = time.perf_counter(), trainer.step
    st["prof"].stop()


def _traced(ctx, st, spans, batches, t0, step0) -> Dict:
    """The traced run's record for the per-layer readers, `busy_s`,
    `window_s` and the breakdown."""
    cfg = ctx.cfg
    if st["t0"] is None:
        raise RuntimeError("the window closed before the profiler window "
                           "opened: give the run more seconds")
    steps_before = st["step0"] - step0
    ms_per_step = (st["t0"] - t0) / steps_before * 1e3
    summary = trace.summarize(st["prof"])
    prof_steps = st["step1"] - st["step0"]
    # window steps run batch (step - step0) mod len(batches)
    idx = [(s - step0) % len(batches) for s in range(st["step0"], st["step1"])]
    unique = [sum(len(_table_ids([batches[i]], feats))
                  for feats in ctx.reference.tables(cfg).values())
              for i in idx]
    ctx.log(f"traced: {steps_before} steps before the profiler at "
            f"{ms_per_step} ms/step; {prof_steps} steps profiled in "
            f"{st['t1'] - st['t0']} s; unique ids per profiled step "
            f"(the benchmark's count) {float(np.mean(unique))}")
    rec = {"kind": "train", "steps": steps_before, "ms_per_step": ms_per_step,
           "span_s": spans.seconds(before=st["t0"]),
           "flops_per_step": cfg["batch_size"]
           * ctx.reference.train_flops_per_example(cfg),
           "row_bytes_per_step": flops.row_kernel_bytes(float(np.mean(unique)),
                                                        cfg),
           "peak": flops.peak(ctx.device_kind), "prof": None}
    out = {"record": rec, "window_s": st["t1"] - st["t0"], "busy_s": 0.0}
    if summary is not None:
        rec["prof"] = dict(summary, steps=prof_steps)
        out["busy_s"] = summary["busy_s"]
        out["breakdown"] = {"device_ops": summary["top_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    return out

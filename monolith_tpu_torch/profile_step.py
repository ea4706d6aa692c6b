"""Where the time of a full-width train step of the port goes, on the card.

    python -m monolith_tpu_torch.profile_step [--config deepfm|multislot|
                                                        multislot_bf16]
                                              [--steps 20] [--trace PATH]
                                              [--block K] [--async]
    python -m monolith_tpu_torch.profile_step --serve [--config ...]
                                              [--steps 20] [--trace PATH]

Builds the trainer of one of bench.py's configs at full width:

- `deepfm` (default): capacity 2^21, unique_cap 32768, batch 8192, hidden
  (256, 128, 64), f32 pool;
- `multislot` (bench.py's default multislot): 16 + 1 tables merged into
  one f32 pool of 17 x 2^18 rows (2,281,701,376 B), 40 slots + a 20-long
  DIN history, f32 dense tower (256, 128, 64), unique_cap 49152, batch
  8192;
- `multislot_bf16` (MT_BENCH_DTYPE=bf16): the same with a bf16 pool
  (stochastic rounding) and a bf16 dense tower;

warms it up, then runs four windows of `--steps` train steps each, on
fresh batches:

1. no profiler: ms/step on the host clock (synchronised at both ends);
2. torch.profiler (CPU + CUDA): device time per step (the union of device
   intervals), by kernel name and by backward node (the device time of
   the kernels each autograd node launched), largest first; the busy
   share is that time over window 1's step (the profiler slows the host,
   so its own window's ms/step is not the step time; idle share =
   1 - busy);
3. cProfile: host time by Python function (tottime), largest first;
4. prepare_wire alone (the C++ dedup + map + pack), ms per batch.

With `--block K` the windows run the block path instead, through
`Trainer.train` (steps_per_dispatch K): block k+1 is packed and its upload
started (`stage_block`) right after block k is dispatched
(`train_step_block`); `--steps` is rounded down to whole blocks; after
window 1 the per-step path (`train_step`, always synchronous) and the
block path run in turns in the same trainer (per-step, block, block,
per-step). `--async` turns on `EngineConfig.async_optimize` (the
1-step-stale block; it needs `--block`). The block path also reports the
device operations (kernels and copies) per step, and a fifth window under
a recording of the program's spans (utils/tracing.py): calls, ms and self
ms per step of each span, the host prepare (`stage.prepare`), the batch
copy and the upload's start among them, the calling thread's spans first,
then the stage worker's (steps 1..K-1 of each block), with the share of
the worker's prepares whose wire was ready when its step took it.

With `--serve` it measures a serving replica instead: the trainer takes 25
full-width steps, is exported, and a `ServingModel` loads the export on the
card (unique_cap 32768 for deepfm, 49152 for the multislots, batch 8192).
After 3 warm-up predicts: window 1, `--steps` predicts through
`ServingModel.predict` (ms per predict, it returns numpy and so waits for
the card); window 2, the same number split into host prepare (dedup + id ->
row lookup), device (upload, lookup, pooling, tower; waited for) and
readback; window 3 under torch.profiler: device busy per predict, its
share of window 1's predict, and device operations per predict, with the
largest kernels. It also prints the export and load seconds and the pools'
bytes on the device.

`--trace` also writes the Chrome trace. Needs the card.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import io
import pstats
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from monolith_tpu_torch.utils import tracing


def _device_intervals(prof):
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.time_range.start, e.time_range.end))
    return sorted(out)


def _union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _kernel_count(event):
    """Kernels launched by a profiler event and the ops under it."""
    return len(event.kernels) + sum(_kernel_count(c)
                                    for c in event.cpu_children)


def _trainer_config(cap, steps_per_dispatch=1, **engine):
    """`engine`: EngineConfig settings (async_optimize, record_touch,
    tiered, packed, compact_wire, ...)."""
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import TrainerConfig
    return TrainerConfig(
        engine=EngineConfig(num_shards=1, unique_cap=cap, new_cap=cap,
                            **engine),
        log_every=0, steps_per_dispatch=steps_per_dispatch)


def _deepfm(ttl_seconds=0, **cfg):
    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer
    trainer = Trainer(DeepFMTask(embedding_dim=16, capacity_per_shard=1 << 21,
                                 hidden=(256, 128, 64),
                                 ttl_seconds=ttl_seconds),
                      _trainer_config(32768, **cfg))
    return trainer, SyntheticCTR(num_users=1_000_000, num_items=200_000,
                                 batch_size=8192, seed=0)


def _multislot(merge_max_gb=0.0, batch_size=8192, unique_cap=49152,
               capacity_per_shard=1 << 18, table_dtype=torch.float32,
               device=None, **cfg):
    """bench.py:224-242: 16 + 1 tables merged into one pool (bins of at
    most `merge_max_gb` GiB, as MT_BENCH_MERGE_MAX_GB; 0 = one pool).
    An f32 pool has an f32 tower and no rounding; a bf16 pool
    (MT_BENCH_DTYPE=bf16) rounds stochastically and has a bf16 tower."""
    from monolith_tpu_torch.data.synthetic import SyntheticMultiSlot
    from monolith_tpu_torch.models.multislot import MultiSlotTask
    from monolith_tpu_torch.training.trainer import Trainer
    bf16 = table_dtype == torch.bfloat16
    trainer = Trainer(
        MultiSlotTask(num_tables=16, num_slots=40, embedding_dim=16,
                      capacity_per_shard=capacity_per_shard,
                      history_length=20, hidden=(256, 128, 64), merge=True,
                      merge_max_bytes=int(merge_max_gb * (1 << 30)),
                      table_dtype=table_dtype, stochastic_rounding=bf16,
                      dense_dtype=torch.bfloat16 if bf16 else None),
        _trainer_config(unique_cap, **cfg), device=device)
    return trainer, SyntheticMultiSlot(num_slots=40, vocab_per_slot=100_000,
                                       history_length=20,
                                       batch_size=batch_size, seed=0)


def _multislot_bf16(**kw):
    return _multislot(table_dtype=torch.bfloat16, **kw)


#: bench.py's configs at full width: name -> (steps_per_dispatch=1,
#: EngineConfig settings) -> (trainer on the card, data stream);
#: chip_smoke.py drives the same three (deepfm also with a table ttl,
#: `ttl_seconds=`; multislot_bf16 also at another `batch_size` and
#: `unique_cap`; multislot also binned, `merge_max_gb=1.0`)
CONFIGS = {"deepfm": _deepfm, "multislot": _multislot,
           "multislot_bf16": _multislot_bf16}
#: a serving replica's unique ids per predict at batch 8192, by config
SERVE_UNIQUE_CAP = {"deepfm": 32768, "multislot": 49152,
                    "multislot_bf16": 49152}
BACKWARD_NODE = "autograd::engine::evaluate_function: "
#: name fragments of the kernels in csrc/ (K1, K2, K3)
PORT_KERNELS = ("gather_rows_kernel", "scatter_rows_kernel",
                "stochastic_round_bf16_kernel")


def serve_main(args):
    """The --serve windows (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from monolith_tpu_torch.serving import ServingModel, export_model

    trainer, data = CONFIGS[args.config]()
    for _ in range(25):
        trainer.train_step(*data.batch())
    torch.cuda.synchronize()
    work = tempfile.mkdtemp(prefix="profile_serve_")
    try:
        t0 = time.perf_counter()
        path = export_model(trainer, work)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = ServingModel(trainer.task, path,
                             unique_cap=SERVE_UNIQUE_CAP[args.config])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = args.steps
    for _ in range(3):
        model.predict(*data.batch())
    windows = [[data.batch() for _ in range(n)] for _ in range(3)]
    t0 = time.perf_counter()
    for fb, b in windows[0]:
        model.predict(fb, b)
    total_ms = (time.perf_counter() - t0) / n * 1e3
    parts = []
    for fb, b in windows[1]:
        parts.append({})
        model.predict(fb, b, timing=parts[-1])
    prep_ms, device_ms, read_ms = (
        sum(p[k] for p in parts) / n
        for k in ("prepare_ms", "device_ms", "readback_ms"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fb, b in windows[2]:
            model.predict(fb, b)
    intervals = _device_intervals(prof)
    busy_ms = _union_us(intervals) / 1e3 / n
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    pool_bytes = sum(p.numel() * p.element_size()
                     for p in model.pools.values())
    print(f"config {args.config}, serving after 25 train steps: export "
          f"{export_s} s, load {load_s} s, rows {model.table_sizes()}, pools "
          f"{pool_bytes} bytes on the device")
    print(f"ms/predict {total_ms} (batch 8192, {n} predicts, no profiler); "
          f"split over {n} more: host prepare {prep_ms}, device (upload + "
          f"forward, waited for) {device_ms}, readback {read_ms}; device busy "
          f"{busy_ms} ms/predict = {busy_ms / total_ms} of the unprofiled "
          f"predict (idle {1 - busy_ms / total_ms}); device operations "
          f"(kernels and copies) {len(intervals) / n} per predict")
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    rows = sorted((a for a in avgs if getattr(a, key) > 0),
                  key=lambda a: -getattr(a, key))
    print("device time per predict by kernel (ms):")
    for a in rows[:12]:
        print(f"  {getattr(a, key) / 1e3 / n:9.4f}  x{a.count / n:5.1f}"
              f"  {a.key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(CONFIGS), default="deepfm")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--trace", default="")
    p.add_argument("--block", type=int, default=1, metavar="K",
                   help="run blocks of K steps (stage_block + "
                        "train_step_block)")
    p.add_argument("--async", dest="async_optimize", action="store_true",
                   help="the 1-step-stale block (needs --block)")
    p.add_argument("--serve", action="store_true",
                   help="measure a serving replica's predict instead")
    args = p.parse_args(argv)
    K = args.block
    if args.async_optimize and K < 2:
        p.error("--async needs --block K with K > 1")
    if args.serve:
        if K > 1:
            p.error("--serve takes no --block")
        return serve_main(args)

    from torch.profiler import ProfilerActivity, profile

    trainer, data = CONFIGS[args.config](
        steps_per_dispatch=K, async_optimize=args.async_optimize)
    for _ in range(5):
        trainer.train_step(*data.batch())
    n = args.steps // K * K
    windows = [[data.batch() for _ in range(n)] for _ in range(4)]
    if K > 1:  # sizes the block's pinned buffers outside the windows
        trainer.train(iter([data.batch() for _ in range(K)]), steps=K)

    def run(batches, blocks=K > 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if blocks:
            trainer.train(iter(batches), steps=len(batches))
        else:
            for fb, b in batches:
                trainer.train_step(fb, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    plain_ms = run(windows[0])
    if K > 1:
        # the per-step path beside the block path in one process, in turns
        # (per-step, block, block, per-step), each on fresh batches
        turns = [run([data.batch() for _ in range(n)], blocks=b)
                 for b in (False, True, True, False)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = run(windows[1])
    intervals = _device_intervals(prof)
    busy_ms = _union_us(intervals) / 1e3 / n
    host_prof = cProfile.Profile()
    host_prof.enable()
    cprof_ms = run(windows[2])
    host_prof.disable()
    t0 = time.perf_counter()
    for fb, _ in windows[3]:
        trainer.engine.prepare_wire(fb, ts=int(time.time()))
    prep_ms = (time.perf_counter() - t0) / n * 1e3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    path = "per-step path" if K == 1 else (
        f"{'asynchronous' if args.async_optimize else 'synchronous'} block "
        f"path, K = {K}")
    print(f"config {args.config}, {path}: ms/step {plain_ms} (no profiler, "
          f"{n} steps); under torch.profiler {prof_ms}; device busy {busy_ms} ms/step = "
          f"{busy_ms / plain_ms} of the unprofiled step (idle "
          f"{1 - busy_ms / plain_ms}); under cProfile {cprof_ms}; "
          f"prepare_wire alone {prep_ms} ms/batch; device operations "
          f"(kernels and copies) {len(intervals) / n} per step")
    if K > 1:
        print(f"in turns, ms/step over {n} steps each (no profiler): per-step "
              f"path {turns[0]}, block {turns[1]}, block {turns[2]}, per-step "
              f"path {turns[3]}")
        with tracing.recording() as rec:
            recorded_ms = run([data.batch() for _ in range(n)])
        print(f"the program's spans over {n} more steps ({recorded_ms} "
              f"ms/step recorded): span, calls, ms and self ms per step")
        main = threading.get_ident()
        for thread in sorted({s.thread for s in rec.spans},
                             key=lambda t: t != main):
            if thread != main:
                print("  on the stage worker's thread:")
            for name, t in rec.totals(thread=thread).items():
                print(f"  {name:18s} {t.count / n:6.3f} "
                      f"{t.seconds / n * 1e3:9.4f} "
                      f"{t.self_seconds / n * 1e3:9.4f}")
        worked = sum(s.name == "stage.prepare" and s.thread != main
                     for s in rec.spans)
        if worked:
            late = sum(s.name == "stage.wire_wait" for s in rec.spans)
            print(f"stage worker: {worked} prepares, {late} wires late: "
                  f"hit share {1 - late / worked}")
    out = io.StringIO()
    pstats.Stats(host_prof, stream=out).sort_stats("tottime").print_stats(25)
    print("host time by function (cProfile, whole window):")
    print(out.getvalue())
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    rows = sorted((a for a in avgs if getattr(a, key) > 0),
                  key=lambda a: -getattr(a, key))
    own = [a for a in rows if any(k in a.key for k in PORT_KERNELS)]
    for title, sel in (("", rows[:20]), (" (the port's own kernels)", own)):
        print(f"device time per step by kernel{title} (ms):")
        for a in sel:
            print(f"  {getattr(a, key) / 1e3 / n:9.4f}  x{a.count / n:5.1f}"
                  f"  {a.key[:100]}")
    node_us, node_kernels = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.name.startswith(BACKWARD_NODE):
            node = e.name[len(BACKWARD_NODE):]
            node_us[node] += getattr(e, key.replace("self_", ""))
            node_kernels[node] += _kernel_count(e)
    print("device time per step by backward node (ms, kernels per step):")
    for node, us in node_us.most_common(12):
        print(f"  {us / 1e3 / n:9.4f}  x{node_kernels[node] / n:5.1f}  {node}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()

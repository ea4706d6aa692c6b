"""Where the time of the port's full-width DeepFM train step goes, on the card.

    python -m monolith_tpu_torch.profile_step [--steps 20] [--trace PATH]

Builds the main path's trainer (bench.py's deepfm config: capacity 2^21,
unique_cap 32768, batch 8192, hidden (256, 128, 64)), warms it up, then
runs four windows of `--steps` train steps each, on fresh batches:

1. no profiler: ms/step on the host clock (synchronised at both ends);
2. torch.profiler (CPU + CUDA): device time per step (the union of device
   intervals) and by kernel name, largest first; the busy share is that
   time over window 1's step (the profiler slows the host, so its own
   window's ms/step is not the step time; idle share = 1 - busy);
3. cProfile: host time by Python function (tottime), largest first;
4. prepare_wire alone (the C++ dedup + map + pack), ms per batch.

`--trace` also writes the Chrome trace. Needs the card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import time

import torch


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


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--trace", default="")
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from monolith_tpu_torch.data.synthetic import SyntheticCTR
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.models.deepfm import DeepFMTask
    from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

    trainer = Trainer(DeepFMTask(embedding_dim=16, capacity_per_shard=1 << 21,
                                 hidden=(256, 128, 64)),
                      TrainerConfig(engine=EngineConfig(
                          num_shards=1, unique_cap=32768, new_cap=32768),
                          log_every=0))
    data = SyntheticCTR(num_users=1_000_000, num_items=200_000,
                        batch_size=8192, seed=0)
    for _ in range(5):
        trainer.train_step(*data.batch())
    n = args.steps
    windows = [[data.batch() for _ in range(n)] for _ in range(4)]

    def run(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fb, b in batches:
            trainer.train_step(fb, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    plain_ms = run(windows[0])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = run(windows[1])
    busy_ms = _union_us(_device_intervals(prof)) / 1e3 / n
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
    print(f"ms/step {plain_ms} (no profiler, {n} steps); under "
          f"torch.profiler {prof_ms}; device busy {busy_ms} ms/step = "
          f"{busy_ms / plain_ms} of the unprofiled step (idle "
          f"{1 - busy_ms / plain_ms}); under cProfile {cprof_ms}; "
          f"prepare_wire alone {prep_ms} ms/batch")
    out = io.StringIO()
    pstats.Stats(host_prof, stream=out).sort_stats("tottime").print_stats(25)
    print("host time by function (cProfile, whole window):")
    print(out.getvalue())
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    rows = sorted((a for a in avgs if getattr(a, key) > 0),
                  key=lambda a: -getattr(a, key))
    print("device time per step by kernel (ms):")
    for a in rows[:20]:
        print(f"  {getattr(a, key) / 1e3 / n:9.4f}  x{a.count / n:5.1f}"
              f"  {a.key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()

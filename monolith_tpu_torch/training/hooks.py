"""Training hooks: callables `hook(trainer, step_output)` that
`Trainer.train` calls after every step (after every block under block
dispatch). The port of the JAX package's training/hooks.py (ref
metric/metric_hook.py:44 ThroughputMetricHook, :143 Tf2ProfilerHook;
deep-insight emission native_model.py:619-655; machine_info
logging_ops.py:31 + MachineInfoHook).

What the card changes: the step output's "preds" is a tensor on the
device. `ThroughputHook` reads its first dimension from the shape, which
needs no readback; `DeepInsightHook` copies the predictions to the host,
one readback per call. `ProfilerHook` records with torch.profiler and
writes a Chrome trace into its `logdir`, with the program's spans in it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from monolith_tpu_torch.utils import tracing
from monolith_tpu_torch.utils.deep_insight import DeepInsightClient
from monolith_tpu_torch.utils.metrics_client import (MetricClient,
                                                     get_metric_client)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ThroughputHook:
    """Emits examples/sec and step latency (ref ThroughputMetricHook).

    The examples of a call are the first dimension of "preds": B for a
    step, and K for a block of K steps (preds [K, B]), which counts K
    examples a block as the JAX package's hook does."""

    def __init__(self, every: int = 100, client: Optional[MetricClient] = None):
        self.every = every
        self.client = client or get_metric_client()
        self._t0 = None
        self._examples = 0

    def __call__(self, trainer, out):
        bsz = out["preds"].shape[0]
        self._examples += bsz
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._examples = 0
            return
        if trainer.step % self.every == 0:
            dt = time.perf_counter() - self._t0
            eps = self._examples / max(dt, 1e-9)
            self.client.emit_store("throughput.examples_per_sec", eps)
            self.client.emit_store("throughput.steps_per_sec",
                                   self.every / max(dt, 1e-9))
            self._t0 = time.perf_counter()
            self._examples = 0


class ExchangeMetricsHook:
    """Per-table embedding-exchange size metrics (ref
    --enable_alltoall_metrics, distributed_ps_sync.py:59,107-121,416-469):
    emits each table's unique ids per step (the rows the gather moves), new
    admissions, admission-filter drops and cap overflows from the host
    prepare stats; no device readback."""

    def __init__(self, every: int = 100,
                 client: Optional[MetricClient] = None):
        self.every = every
        self.client = client or get_metric_client()

    def __call__(self, trainer, out):
        if trainer.step % self.every != 0:
            return
        stats = out.get("stats")
        if isinstance(stats, list):  # block dispatch: last step's stats
            stats = stats[-1] if stats else None
        if not stats:
            return
        for key in ("unique", "new", "filtered", "new_rejected", "overflow"):
            for tname, v in stats.get(key, {}).items():
                self.client.emit_store(f"exchange.{key}",
                                       float(v), tags={"table": tname})


class ProfilerHook:
    """A torch.profiler trace over the steps [start_step, end_step) (ref
    Tf2ProfilerHook:143, profile_some_steps_from), written into `logdir` as
    a Chrome trace `trace-<start>-<end>.json` when the window closes. The
    card's activity is recorded when the trainer runs on the card.

    Unless one is open already, a recording of the program's spans
    (utils/tracing.py) is open over the same window, so that the trace
    shows them as "mt.<span>" ranges beside the device's operations; the
    spans stay readable in `recording` after the window closes."""

    def __init__(self, logdir: str, start_step: int, end_step: int):
        self.logdir = logdir
        self.start_step = start_step
        self.end_step = end_step
        self._prof = None
        self.trace_path: Optional[str] = None
        self.recording: Optional[tracing.Recording] = None

    def __call__(self, trainer, out):
        import torch
        if self._prof is None and self.start_step <= trainer.step \
                < self.end_step:
            os.makedirs(self.logdir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if trainer.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self.recording = None
            if tracing.active() is None:
                self.recording = tracing.recording().open()
        elif self._prof is not None and trainer.step >= self.end_step:
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
            self._prof.stop()
            self.trace_path = os.path.join(
                self.logdir, f"trace-{self.start_step}-{self.end_step}.json")
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
            if self.recording is not None:
                self.recording.close()


class DeepInsightHook:
    """Per-example quality emission (ref deep_insight_ops.py:43); copies
    the predictions to the host, one readback a call."""

    def __init__(self, client: DeepInsightClient):
        self.client = client

    def __call__(self, trainer, out):
        labels = out.get("labels")
        if labels is None:
            return
        self.client.emit(_host(labels), _host(out["preds"]))


class CheckpointHook:
    """Periodic checkpoints (ref NoFirstSaveCheckpointSaverHook
    save_utils.py:248, which also skips the step-0 save)."""

    def __init__(self, directory: str, every_steps: int,
                 evict_before_save: bool = False):
        self.directory = directory
        self.every = every_steps
        self.evict = evict_before_save

    def __call__(self, trainer, out):
        from monolith_tpu_torch.training import checkpoint
        if trainer.step > 0 and trainer.step % self.every == 0:
            checkpoint.save(trainer, self.directory,
                            evict_before_save=self.evict)


def machine_info() -> dict:
    """Host health snapshot (ref logging_ops.cc machine_info)."""
    info = {"ts": time.time()}
    try:
        load1, load5, load15 = os.getloadavg()
        info.update(load1=load1, load5=load5, load15=load15)
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            mem = {}
            for line in f:
                k, _, rest = line.partition(":")
                mem[k] = int(rest.strip().split()[0])
        info["mem_total_kb"] = mem.get("MemTotal", 0)
        info["mem_available_kb"] = mem.get("MemAvailable", 0)
    except (OSError, ValueError):
        pass
    return info


class MachineInfoHook:
    """Emits host health to metrics (ref hooks/ps_check_hooks.py)."""

    def __init__(self, every: int = 500, client: Optional[MetricClient] = None):
        self.every = every
        self.client = client or get_metric_client()

    def __call__(self, trainer, out):
        if trainer.step % self.every == 0:
            info = machine_info()
            for k in ("load1", "mem_available_kb"):
                if k in info:
                    self.client.emit_store(f"machine.{k}", info[k])


class TideHook:
    """Run training only inside a daily time window (ref
    session_run_hooks.py:144 TideStoppingHook: "tide" preemptible resources
    available only at certain hours). Outside the window the hook saves a
    checkpoint and blocks, or with block=False raises StopIteration so that
    the training loop exits cleanly (the reference's stop-and-resume
    pattern)."""

    def __init__(self, start_hour: int, end_hour: int, start_minute: int = 0,
                 end_minute: int = 0, block: bool = True,
                 ckpt_dir: Optional[str] = None, poll_sec: float = 30.0,
                 clock=time.time):
        self.start = start_hour * 60 + start_minute
        self.end = end_hour * 60 + end_minute
        self.block = block
        self.ckpt_dir = ckpt_dir
        self.poll_sec = poll_sec
        self.clock = clock

    def _in_window(self) -> bool:
        t = time.gmtime(self.clock())
        now = t.tm_hour * 60 + t.tm_min
        if self.start <= self.end:
            return self.start <= now < self.end
        return now >= self.start or now < self.end  # window wraps midnight

    def __call__(self, trainer, out) -> None:
        if self._in_window():
            return
        if self.ckpt_dir:
            from monolith_tpu_torch.training import checkpoint
            checkpoint.save(trainer, self.ckpt_dir)
        if not self.block:
            raise StopIteration("outside tide window")
        while not self._in_window():
            time.sleep(self.poll_sec)


class SlowStartHook:
    """Staggered worker start (ref session_run_hooks.py:53
    CustomGlobalStepWaiterHook): before the first step, wait until the
    shared global step (read via `step_fn`) reaches `wait_until_step`, or
    until `max_wait_sec` passes. Typical use: wait_until_step =
    int(K * log(worker_id + 1))."""

    def __init__(self, wait_until_step: int, step_fn,
                 max_wait_sec: float = 600.0, poll_sec: float = 0.5):
        self.wait_until_step = wait_until_step
        self.step_fn = step_fn
        self.max_wait_sec = max_wait_sec
        self.poll_sec = poll_sec
        self.started = False

    def wait(self) -> None:
        t0 = time.time()
        while not self.started:
            if self.step_fn() >= self.wait_until_step:
                self.started = True
            elif time.time() - t0 > self.max_wait_sec:
                self.started = True
            else:
                time.sleep(self.poll_sec)

    def __call__(self, trainer, out) -> None:
        if not self.started:
            self.wait()

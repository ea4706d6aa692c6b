"""What a traced run reads of the program's own spans (monolith_tpu_torch/
utils/tracing.py, `mt.` ranges in a profiler's trace) beside the
benchmark's.

- `summarize(prof)`: `trace.summarize` of a profiler window whose device
  timeline may hold the program's `mt.` ranges as well as the benchmark's
  `pb.` ones: both are ranges, not device work, so both are left out of
  the busy time and the operation count.
- `kernel_seconds_under(prof, name)`: device seconds of the kernels that
  the ops inside the host range `name` (an `mt.` span of the calling
  thread) launched, from the profiler's tree of host events; None when
  the window holds no such range.
- `window(rec, t0, t1)`: the recording's spans and counters that closed
  in [t0, t1], split into the stage worker's thread and the others.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench import trace

PROGRAM = "mt."


class _Events:
    """A profiler's events less the device-timeline copies of `mt.`
    ranges."""

    def __init__(self, prof):
        self._events = [e for e in prof.events()
                        if not (e.device_type == torch.autograd.DeviceType.CUDA
                                and e.name.startswith(PROGRAM))]

    def events(self):
        return self._events


def summarize(prof) -> Optional[Dict]:
    return trace.summarize(_Events(prof))


def kernel_seconds_under(prof, name: str) -> Optional[float]:
    tops = [e for e in prof.events() if e.name == name
            and e.device_type == torch.autograd.DeviceType.CPU]
    if not tops:
        return None
    us, stack = 0.0, list(tops)
    while stack:
        e = stack.pop()
        us += sum(k.duration for k in e.kernels)
        stack.extend(e.cpu_children)
    return us / 1e6


def window(rec, t0: float, t1: float) -> Dict:
    """{"worker": {span: [count, seconds]}, "main": {...}, "counters":
    {name: [count, sum]}} over the spans that opened at or after `t0` and
    closed by `t1`; the worker is the thread of the `stage.worker`
    spans."""
    spans = rec.spans
    workers = {s.thread for s in spans if s.name == "stage.worker"}
    out = {"worker": {}, "main": {}, "counters": {}}
    for s in spans:
        if s.end is None or s.start < t0 or s.end > t1:
            continue
        side = out["worker" if s.thread in workers else "main"]
        t = side.setdefault(s.name, [0, 0.0])
        t[0] += 1
        t[1] += s.end - s.start
    totals = getattr(rec, "counter_totals", None)   # a program without
    if totals is not None:                          # counters has none
        out["counters"] = {k: list(v) for k, v in
                           totals(after=t0, before=t1).items()}
    return out

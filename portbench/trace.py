"""Spans, and the reading of a torch.profiler window.

Spans are the benchmark's own: `Spans.wrap` times a call into the program
on the host clock and, while a profiler runs, marks it in the trace as a
`pb.<name>` range, so that an idle gap of the device can be named by what
the host was doing. `device_intervals` and `union_us` are copies of
`monolith_tpu_torch/profile_step.py`'s busy-share arithmetic, the former
leaving out those spans' ranges on the device's timeline.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

PREFIX = "pb."


class Spans:
    """Host-clock spans [(name, start, end)], in the order they closed."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        def timed(*args, **kwargs):
            t = time.perf_counter()
            with record_function(PREFIX + name):
                out = fn(*args, **kwargs)
            self.items.append((name, t, time.perf_counter()))
            return out
        return timed

    def seconds(self, before: float = float("inf")) -> Dict[str, float]:
        """Seconds by span name, over the spans that closed before
        `before`."""
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.items:
            if e <= before:
                out[name] += e - s
        return dict(out)


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler(device):
    """A torch.profiler over the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm_profiler(device) -> None:
    """Start and stop a profiler once on a small op, so that the profiler's
    own start-up is paid in set-up and not inside a window."""
    with profiler(device):
        (torch.ones(8, device=device) * 2).sum().item()


def on_device(events) -> list:
    """The operations that ran on the device: kernels and copies, not the
    ranges the profiler draws on the device's timeline for the host's
    `record_function` spans."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(PREFIX)]


def device_intervals(events) -> List[Tuple[float, float]]:
    return sorted((e.time_range.start, e.time_range.end)
                  for e in on_device(events))


def union_us(intervals) -> float:
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


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, top: int = 10) -> Optional[Dict]:
    """What a profiler window shows, or None when no operation ran on the
    device: {"busy_s", "device_ops", "kernel_s": {name: s}, "top_ops":
    [[name, s], ...], "idle_gaps": [[host span, s], ...]}, the gaps being
    the longest between device operations, each named by the innermost
    `pb.` span open on the host when it began ("other" outside them)."""
    events = prof.events()
    dev = on_device(events)
    if not dev:
        return None
    kernel_us: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        kernel_us[e.name] += e.time_range.end - e.time_range.start
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
                   for e in events if e.name.startswith(PREFIX)
                   and e.device_type != torch.autograd.DeviceType.CUDA)
    merged = _merged(device_intervals(dev))
    gaps = []
    for (_, end), (start, _) in zip(merged[:-1], merged[1:]):
        inner = [(s, name) for s, e, name in spans if s <= end < e]
        gaps.append((max(inner)[1] if inner else "other",
                     (start - end) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(kernel_us.items(), key=lambda kv: -kv[1])
    return {"busy_s": union_us(device_intervals(dev)) / 1e6,
            "device_ops": len(dev),
            "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
            "top_ops": [[k[:120], v / 1e6] for k, v in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}


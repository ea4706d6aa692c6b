"""Device timing of one call on the card, for chip_smoke.py and
bench_rows.py.

Two clocks over the same protocol (3 warm-up calls, then `reps` calls, each
after a 256 MB write that evicts the 50 MB L2, since the main path finds
its rows cold; `flush="read"` reads the 256 MB instead, which leaves the L2
holding clean lines, so that a kernel's reads evict nothing that must be
written back first):

- `event_times_ms` / `time_ms` (their mean): two CUDA events around every
  call. The reading holds a fixed cost of the events and the launch beside
  the kernel's own time; `event_floor_ms` measures it with an empty kernel.
- `profiler_ms`: the kernel's own duration from a torch.profiler window
  (CPU + CUDA), by kernel name.

Needs the card.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

FLUSH_WORDS = 64 << 20   # 256 MB of f32


def warm_up(seconds: float = 1.0) -> None:
    """Keep the card busy for about `seconds` before the first timing, so
    that it is not taken while the clocks still ramp up."""
    a = torch.randn((4096, 4096), device="cuda")
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def _first_calls(fn: Callable[[], object]) -> None:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()


def _flushed_calls(fn: Callable[[], object], reps: int, between=None,
                   flush: str = "write"):
    buf = torch.zeros(FLUSH_WORDS, dtype=torch.float32, device="cuda")
    evict = {"write": buf.zero_, "read": buf.sum}[flush]
    out = []
    for _ in range(reps):
        evict()
        out.append(between() if between is not None else fn())
    torch.cuda.synchronize()
    return out


def event_times_ms(fn: Callable[[], object], reps: int = 20,
                   flush: str = "write") -> List[float]:
    """Device time of each of `reps` calls of fn() by CUDA events, each
    call after an L2 flush."""
    def bracket():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        return start, end

    _first_calls(fn)
    return [s.elapsed_time(e)
            for s, e in _flushed_calls(fn, reps, bracket, flush)]


def time_ms(fn: Callable[[], object], reps: int = 20,
            flush: str = "write") -> float:
    """Mean of `event_times_ms`."""
    return sum(event_times_ms(fn, reps, flush)) / reps


#: profiler windows profiler_ms takes at most for one reading
PROFILER_WINDOWS = 3


def profiler_ms(fn: Callable[[], object], kernel: str, reps: int = 20,
                flush: str = "write") -> Optional[float]:
    """Mean duration of the kernels whose name contains `kernel`, from a
    torch.profiler window over `reps` flushed calls of fn(); None where
    PROFILER_WINDOWS windows in a row recorded no device time for that
    name. A window can come back without the device's records (seen once
    in ~60 windows of one process on an H100), so an empty one is taken
    again."""
    from torch.profiler import ProfilerActivity, profile
    _first_calls(fn)
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _flushed_calls(fn, reps, flush=flush)
        total_us, count = 0.0, 0
        for a in prof.key_averages():
            us = getattr(a, "self_device_time_total",
                         getattr(a, "self_cuda_time_total", 0.0))
            if kernel in a.key and us > 0:
                total_us += us
                count += a.count
        if count:
            return total_us / count / 1e3
    return None


def event_floor_ms(reps: int = 20) -> float:
    """`time_ms` of an empty kernel: what the two events and one launch
    cost with nothing between them."""
    from monolith_tpu_torch.ops import scatter
    lib = scatter.kernel_library()

    def noop():
        err = lib.mt_noop(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mt_noop: launch failed (CUDA error {err})")

    return time_ms(noop, reps)

"""Spans of the program's own layers, kept in memory while a recording is
open.

    from monolith_tpu_torch.utils import tracing

    with tracing.recording() as rec:
        trainer.train(data, steps=64)
    rec.totals()["step.backward"]   # (count, seconds, self seconds)

`span(name, step)` marks a layer boundary (the trainer's stage, dispatch,
step and its parts). With no recording open it returns one shared object
that does nothing: the cost is a function call and the test of one module
variable, with no allocation, no clock read and no torch call. Nothing but
a recording turns spans on: no environment variable, no trainer setting.

While a recording is open each span keeps (name, start, end, parent, step,
thread): `start` and `end` on `time.perf_counter()`'s clock, `parent` the
index of the enclosing span open on the same thread (-1 at the top), so
that a span's self time is its duration less its children's; `step` the
step number of a per-step span, the block's base step for a block span.
Spans open on more than one thread (the trainer's stage worker packs
beside the dispatching thread), each with its own parents. Spans past the
recording's `capacity` are counted in `dropped`, not kept. While a
torch.profiler also runs, each span enters a `record_function` range
"mt.<name>" too, which puts it in the profiler's trace beside the device's
operations; the profiler keeps the ranges of the thread that started it
only, so the stage worker's spans are in the recording alone. Outside a
profiler no range is entered, so a traced step pays only the clock
reads. A recording also keeps every garbage collection as a span
"host.gc" (`arg` its generation), through a `gc.callbacks` entry that it
removes when it closes.

`count(name, value, step)` records a number beside the spans (the
trainer's prepare counts its ids, unique ids and wide tables a step): a
(name, value, step, thread, time) entry while a recording is open, and
nothing, at the same cost as a span's, while none is. `rec.counters` lists
them, `rec.counter_totals()` sums them by name.

One recording is open at a time: the spans are the process's, as the
profiler's ranges are.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

#: the prefix of the spans' ranges in a torch.profiler trace
PREFIX = "mt."

_active: Optional["Recording"] = None


class Span(NamedTuple):
    name: str
    start: float
    end: Optional[float]        # None while the span is open
    parent: int                 # index of the enclosing span; -1: none
    step: Optional[int]
    thread: int
    arg: Optional[int] = None   # host.gc: the generation collected


class Counter(NamedTuple):
    name: str
    value: float
    step: Optional[int]
    thread: int
    time: float                 # perf_counter seconds when counted


class Total(NamedTuple):
    count: int
    seconds: float
    self_seconds: float


class _Off:
    """The span of a process with no recording open."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "name", "step", "index", "range")

    def __init__(self, rec: "Recording", name: str, step: Optional[int]):
        self.rec, self.name, self.step = rec, name, step

    def __enter__(self):
        self.index, self.range = self.rec._open(self.name, self.step)
        return None

    def __exit__(self, *exc):
        self.rec._close(self.index, self.range)
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager marking `name` (of `step`) in the open recording;
    a shared no-op when none is open."""
    rec = _active
    if rec is None:
        return _OFF
    return _On(rec, name, step)


def count(name: str, value: float, step: Optional[int] = None) -> None:
    """Record `value` under `name` (of `step`) in the open recording;
    nothing when none is open."""
    rec = _active
    if rec is not None:
        rec._count(name, value, step)


def active() -> Optional["Recording"]:
    """The open recording, or None."""
    return _active


class Recording:
    """A bounded in-memory record of spans; open it with `with` (or
    `open()` and `close()`)."""

    def __init__(self, capacity: int = 1 << 18):
        self.capacity = capacity
        self._items: List[Optional[list]] = [None] * capacity
        self._n = 0
        self._taking = threading.RLock()
        self._stacks: Dict[int, List[int]] = {}
        self._gc_open: List[tuple] = []
        self._counts: List[Counter] = []
        self.dropped_counts = 0

    # -- opening and closing -------------------------------------------

    def open(self) -> "Recording":
        global _active
        if _active is not None:
            raise RuntimeError("a recording is already open: recordings "
                               "do not nest")
        _active = self
        gc.callbacks.append(self._on_gc)
        return self

    def close(self) -> None:
        global _active
        if _active is self:
            gc.callbacks.remove(self._on_gc)
            _active = None

    def __enter__(self) -> "Recording":
        return self.open()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- spans -----------------------------------------------------------

    def _open(self, name: str, step: Optional[int], arg=None):
        # the lock keeps a second thread from taking the same index; no
        # call between the read and the write of _n, so a collection
        # (whose callback opens a span on the collecting thread) cannot
        # either, and the lock is reentrant should one run inside it
        with self._taking:
            i = self._n
            self._n = i + 1
        if i >= self.capacity:
            return -1, None
        rng = None
        if _profiler._is_profiler_enabled:
            rng = record_function(PREFIX + name)
            rng.__enter__()
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
        self._items[i] = [name, time.perf_counter(), None,
                          stack[-1] if stack else -1, step, tid, arg]
        stack.append(i)
        return i, rng

    def _close(self, i: int, rng) -> None:
        if i < 0:
            return
        item = self._items[i]
        item[2] = time.perf_counter()
        stack = self._stacks[item[5]]
        if stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
        if rng is not None:
            rng.__exit__(None, None, None)

    def _count(self, name: str, value: float, step: Optional[int]) -> None:
        c = Counter(name, value, step, threading.get_ident(),
                    time.perf_counter())
        with self._taking:
            if len(self._counts) < self.capacity:
                self._counts.append(c)
            else:
                self.dropped_counts += 1

    def _on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_open.append(self._open("host.gc", None,
                                            info["generation"]))
        elif self._gc_open:
            self._close(*self._gc_open.pop())

    # -- reading -----------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Spans not kept: opened past the capacity."""
        return max(0, self._n - self.capacity)

    @property
    def spans(self) -> List[Span]:
        """Every span kept, in the order they opened (a span's index is its
        position here)."""
        return [Span(*item) for item in self._items[:min(self._n,
                                                          self.capacity)]]

    @property
    def counters(self) -> List[Counter]:
        """Every number counted and kept, in the order counted (at most
        `capacity`; the rest in `dropped_counts`)."""
        with self._taking:
            return list(self._counts)

    def counter_totals(self, after: float = -math.inf,
                       before: float = math.inf) -> Dict[str, tuple]:
        """{name: (count, sum)} over the numbers counted between `after`
        and `before` (perf_counter seconds)."""
        out: Dict[str, list] = {}
        for c in self.counters:
            if after <= c.time <= before:
                t = out.setdefault(c.name, [0, 0.0])
                t[0] += 1
                t[1] += c.value
        return {k: tuple(v) for k, v in out.items()}

    def totals(self, before: float = math.inf,
               thread: Optional[int] = None) -> Dict[str, Total]:
        """{name: (count, seconds, self seconds)} over the spans that closed
        by `before` (perf_counter seconds), of one `thread` only if given;
        self seconds leave out the time of the span's children."""
        spans = self.spans
        closed = [s.end is not None and s.end <= before
                  and thread in (None, s.thread) for s in spans]
        child_s = [0.0] * len(spans)
        for s, ok in zip(spans, closed):
            if ok and s.parent >= 0:
                child_s[s.parent] += s.end - s.start
        out: Dict[str, list] = {}
        for i, (s, ok) in enumerate(zip(spans, closed)):
            if ok:
                t = out.setdefault(s.name, [0, 0.0, 0.0])
                t[0] += 1
                t[1] += s.end - s.start
                t[2] += s.end - s.start - child_s[i]
        return {k: Total(*v) for k, v in out.items()}


def recording(capacity: int = 1 << 18) -> Recording:
    """A recording of at most `capacity` spans, to open with `with`."""
    return Recording(capacity)

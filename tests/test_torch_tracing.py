"""The port's spans (monolith_tpu_torch/utils/tracing.py) on the CPU.

Off: a trainer's block records nothing, registers no `gc.callbacks` entry
and enters no `record_function`, under a profiler too; a disabled span
costs about a function call. On: the span tree of the training step (names,
parents, step ids, each child inside its parent) on the block path (the
stage worker's spans on its own thread), the 1-step-stale block, the
per-step path and the structure-of-arrays step; garbage collections as
`host.gc`; the `mt.` ranges a CPU torch.profiler shows for the thread that
started it, name for name and count for count; the capacity; one recording
at a time; `ProfilerHook`'s Chrome trace. Small DeepFM (dim 8, hidden
(16,), batch 32).
"""

import collections
import gc
import json
import threading
import time

import pytest
import torch

from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training.hooks import ProfilerHook
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
from monolith_tpu_torch.utils import tracing

torch.set_num_threads(1)

K = 4
STEP_PARTS = ["step.decode", "step.lookup", "step.pool", "step.forward",
              "step.backward", "step.dense_update", "step.metrics",
              "step.apply"]


def trainer(K=K, **engine):
    return Trainer(DeepFMTask(embedding_dim=8, capacity_per_shard=2048,
                              hidden=(16,)),
                   TrainerConfig(engine=EngineConfig(unique_cap=512,
                                                     new_cap=512, **engine),
                                 log_every=0, steps_per_dispatch=K),
                   device="cpu")


def batches(n, seed=5):
    data = SyntheticCTR(num_users=50, num_items=30, batch_size=32, seed=seed)
    return [data.batch() for _ in range(n)]


def children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def names(spans, idx):
    return [spans[j].name for j in idx]


def check_nesting(spans):
    """Every span closed, inside its parent, on its parent's thread."""
    for s in spans:
        assert s.end is not None and s.start <= s.end, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            assert p.thread == s.thread


def without_gc(spans):
    """The indices of the spans that are not garbage collections (which
    may fall anywhere)."""
    return [i for i, s in enumerate(spans) if s.name != "host.gc"]


def record(tr, pairs, steps, hooks=()):
    with tracing.recording() as rec:
        tr.train(iter(pairs), steps=steps, hooks=hooks)
    return rec.spans


def test_off_records_nothing(monkeypatch):
    """No recording: no span kept, no gc callback, no record_function, and
    no `mt.` range under a running profiler."""
    entered = []
    real = tracing.record_function

    def counting(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(tracing, "record_function", counting)
    callbacks = list(gc.callbacks)
    seen = []
    tr = trainer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.train(iter(batches(8)), steps=8, hooks=(
            lambda *_: seen.append(list(gc.callbacks)),))
    assert tr.step == 8 and len(seen) == 2
    assert all(s == callbacks for s in seen)
    assert entered == []
    assert not [e for e in prof.events()
                if e.name.startswith(tracing.PREFIX)]
    assert tracing.active() is None
    assert tracing.span("train.step", 3) is tracing.span("step.pool")


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "async"])
def test_block_span_tree(stale):
    """Two blocks of K = 4 through `train`: fetch, stage, dispatch, hooks
    at the top of the calling thread; K train.step under each
    train.dispatch, each holding the step's parts (after a
    `stage.wire_wait` where its wire was late); the stage of block k + 1
    holding its wait, step 0's prepare and copy, and its upload. On the
    stage worker's thread a `stage.worker` a block, holding the prepares
    and copies of steps 1..K-1."""
    tr = trainer(async_optimize=True) if stale else trainer()
    spans = record(tr, batches(2 * K), 2 * K)
    check_nesting(spans)
    keep = without_gc(spans)
    main = spans[keep[0]].thread
    top = [i for i in keep if spans[i].parent == -1
           and spans[i].thread == main]
    assert [(spans[i].name, spans[i].step) for i in top] == [
        ("train.fetch", 0), ("train.stage", 0), ("train.dispatch", 0),
        ("train.hooks", 0), ("train.fetch", K), ("train.stage", K),
        ("train.dispatch", K), ("train.hooks", K)]
    worker = [i for i in keep if spans[i].parent == -1
              and spans[i].thread != main]
    assert [(spans[i].name, spans[i].step) for i in worker] == [
        ("stage.worker", 0), ("stage.worker", K)]
    for i in worker:
        kids = [j for j in children(spans, i) if j in keep]
        assert names(spans, kids) == ["stage.prepare",
                                      "stage.copy_batch"] * (K - 1)
        assert [spans[j].step for j in kids] == [
            spans[i].step + s for s in range(1, K) for _ in range(2)]
    for i in top:
        kids = [j for j in children(spans, i) if j in keep]
        base = spans[i].step
        if spans[i].name == "train.stage":
            assert names(spans, kids) == ["stage.wait", "stage.prepare",
                                          "stage.copy_batch", "stage.upload"]
            assert {spans[j].step for j in kids} == {base}
        elif spans[i].name == "train.dispatch":
            steps = kids[:K]
            assert names(spans, steps) == ["train.step"] * K
            assert [spans[j].step for j in steps] == list(range(base,
                                                                base + K))
            # the 1-step-stale block lands its last write-back after the
            # loop
            tail = [("step.apply", base + K - 1)] if stale else []
            assert [(spans[j].name, spans[j].step)
                    for j in kids[K:]] == tail
            for n, j in enumerate(steps):
                parts = [p for p in children(spans, j) if p in keep]
                if names(spans, parts[:1]) == ["stage.wire_wait"]:
                    assert n > 0
                    parts = parts[1:]
                want = list(STEP_PARTS)
                if stale and n:
                    # the previous step's pending write-back, before the
                    # forward
                    want.insert(2, "step.apply")
                assert names(spans, parts) == want
                assert {spans[p].step for p in parts} == {base + n}
        else:
            assert [j for j in children(spans, i) if j in keep] == []


@pytest.mark.parametrize("packed", ["auto", "off"],
                         ids=["packed", "structure_of_arrays"])
def test_per_step_span_tree(packed):
    """The per-step path (K = 1), and the structure-of-arrays step: the
    loop's groups of one, a train.fetch, a train.stage, a train.step and
    a train.hooks per step, the same parts."""
    tr = trainer(K=1, packed=packed)
    spans = record(tr, batches(3), 3)
    check_nesting(spans)
    keep = without_gc(spans)
    top = [i for i in keep if spans[i].parent == -1]
    assert [(spans[i].name, spans[i].step) for i in top] == [
        (n, s) for s in range(3)
        for n in ("train.fetch", "train.stage", "train.step",
                  "train.hooks")]
    for i in top:
        kids = names(spans, [j for j in children(spans, i) if j in keep])
        assert kids == {"train.fetch": [],
                        "train.stage": ["stage.wait", "stage.prepare",
                                        "stage.copy_batch", "stage.upload"],
                        "train.step": STEP_PARTS,
                        "train.hooks": []}[spans[i].name]


def test_totals_and_self_time():
    """totals(): counts by name, seconds summed, self seconds the duration
    less the children's."""
    tr = trainer()
    with tracing.recording() as rec:
        tr.train(iter(batches(2 * K)), steps=2 * K)
    spans, totals = rec.spans, rec.totals()
    count = collections.Counter(s.name for s in spans)
    assert {k: t.count for k, t in totals.items()} == dict(count)
    assert totals["train.step"].count == 2 * K
    assert totals["train.dispatch"].count == 2
    for name in ("train.step", "train.dispatch", "train.stage"):
        own = [i for i, s in enumerate(spans) if s.name == name]
        dur = sum(spans[i].end - spans[i].start for i in own)
        kids = sum(spans[j].end - spans[j].start for i in own
                   for j in children(spans, i))
        assert totals[name].seconds == pytest.approx(dur, rel=1e-9)
        assert totals[name].self_seconds == pytest.approx(dur - kids,
                                                          rel=1e-6)
        assert 0 <= totals[name].self_seconds < totals[name].seconds
    # step.pool has no child but a garbage collection, which may fall
    # anywhere (the stage worker's allocations count towards it too)
    pool = {i for i, s in enumerate(spans) if s.name == "step.pool"}
    assert {spans[j].name for i in pool for j in children(spans, i)} <= {
        "host.gc"}
    gc_s = sum(s.end - s.start for s in spans if s.parent in pool)
    assert totals["step.pool"].self_seconds == pytest.approx(
        totals["step.pool"].seconds - gc_s)
    cut = spans[own_first(spans, "train.dispatch")].end
    early = rec.totals(before=cut)
    assert early["train.dispatch"].count == 1
    assert early["train.step"].count == K


def own_first(spans, name):
    return next(i for i, s in enumerate(spans) if s.name == name)


def test_gc_is_recorded():
    with tracing.recording() as rec:
        assert rec._on_gc in gc.callbacks
        with tracing.span("train.hooks", 7):
            gc.collect()
    assert rec._on_gc not in gc.callbacks
    spans = rec.spans
    collected = [s for s in spans if s.name == "host.gc"]
    assert collected and collected[-1].arg == 2
    assert spans[collected[-1].parent].name == "train.hooks"
    check_nesting(spans)


def test_profiler_ranges_match_the_recording():
    """Under a CPU torch.profiler every span of the profiling thread is
    also an `mt.` range: the same names, the same counts. The stage
    worker's spans are in the recording alone."""
    tr = trainer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            tr.train(iter(batches(2 * K)), steps=2 * K)
    ranges = collections.Counter(
        e.name[len(tracing.PREFIX):] for e in prof.events()
        if e.name.startswith(tracing.PREFIX))
    main = threading.get_ident()
    assert ranges == collections.Counter(s.name for s in rec.spans
                                         if s.thread == main)
    assert ranges["train.step"] == 2 * K and ranges["step.backward"] == 2 * K
    assert sum(s.name == "stage.worker" for s in rec.spans) == 2


def test_capacity_counts_dropped():
    with tracing.recording(capacity=5) as rec:
        with tracing.span("outer", 0):
            for i in range(7):
                with tracing.span("inner", i):
                    pass
    spans = rec.spans
    assert len(spans) == 5 and rec.dropped == 3
    assert [s.name for s in spans] == ["outer"] + ["inner"] * 4
    assert all(s.end is not None for s in spans)
    assert [s.parent for s in spans] == [-1, 0, 0, 0, 0]


def test_recordings_do_not_nest():
    with tracing.recording() as rec:
        assert tracing.active() is rec
        with pytest.raises(RuntimeError, match="do not nest"):
            tracing.recording().open()
        assert tracing.active() is rec
    assert tracing.active() is None
    with tracing.recording() as again:
        assert tracing.active() is again


def test_disabled_span_costs_little():
    n = 10 ** 6
    span = tracing.span
    t0 = time.perf_counter()
    for i in range(n):
        with span("step.pool", i):
            pass
    ns = (time.perf_counter() - t0) / n * 1e9
    print(f"disabled span: {ns:.1f} ns a call")
    assert ns < 5000


def test_profiler_hook_trace_shows_spans(tmp_path):
    """ProfilerHook opens a recording over its window: the Chrome trace
    names the program's spans, and the recording closes with the window."""
    tr = trainer()
    hook = ProfilerHook(str(tmp_path / "prof"), start_step=K,
                        end_step=3 * K)
    tr.train(iter(batches(4 * K)), steps=4 * K, hooks=[hook])
    assert tracing.active() is None
    with open(hook.trace_path) as f:
        events = json.load(f)["traceEvents"]
    seen = {str(e.get("name", "")) for e in events}
    assert {"mt.train.dispatch", "mt.step.backward",
            "mt.train.stage"} <= seen
    totals = hook.recording.totals()
    assert totals["train.dispatch"].count == 2
    assert totals["train.step"].count == 2 * K


def test_counters_are_off_without_a_recording():
    """`count` with no recording open keeps nothing, and a block's
    prepares count nothing anywhere."""
    tracing.count("prepare.ids", 5, 0)
    tr = trainer()
    tr.train(iter(batches(K)), steps=K)
    with tracing.recording() as rec:
        pass
    assert rec.counters == [] and rec.counter_totals() == {}


def test_counters_are_recorded_with_a_recording():
    """`count` keeps what it is given, with its step, on the thread that
    counted it; `counter_totals` sums by name within a time window, and
    numbers past the capacity are counted as dropped."""
    main = threading.get_ident()

    def other():
        for step in range(K):
            tracing.count("worker", step + 1, step)
    with tracing.recording() as rec:
        tracing.count("mine", 2.5, 7)
        tracing.count("mine", 1.5, 8)
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
        cut = time.perf_counter()
        tracing.count("late", 3, 9)
    by = collections.defaultdict(list)
    for c in rec.counters:
        by[c.name].append(c)
    assert [(c.value, c.step) for c in by["mine"]] == [(2.5, 7), (1.5, 8)]
    assert {c.thread for c in by["mine"]} == {main}
    assert [(c.value, c.step) for c in by["worker"]] == [
        (s + 1, s) for s in range(K)]
    assert {c.thread for c in by["worker"]} == {worker.ident} != {main}
    totals = rec.counter_totals()
    assert totals["mine"] == (2, 4.0)
    assert totals["worker"] == (K, float(sum(range(1, K + 1))))
    assert rec.counter_totals(before=cut) == {
        k: v for k, v in totals.items() if k != "late"}
    assert rec.counter_totals(after=cut) == {"late": (1, 3.0)}
    assert rec.counter_totals(after=time.perf_counter()) == {}
    small = tracing.recording(capacity=2)
    with small:
        for i in range(3):
            tracing.count("x", i)
    assert [c.value for c in small.counters] == [0, 1]
    assert small.dropped_counts == 1

"""The stage worker (training/trainer.py): a block's steps 1..K-1 packed on
a second host thread while the steps before them dispatch, on the CPU.

Held against the serial pack (a Trainer whose `_stage_overlaps()` is
False) bit for bit: the wires, losses, predictions, stats, pool rows,
dense leaves and accumulators, and each host store's id -> row map with
its timestamps and counts; for a staged and an unstaged block of K = 4 and
8, for `train()`'s groups after a first step, synchronous and
1-step-stale, and after a hook's stop. A prepare that raises stops its
block at that step; a dispatch that raises joins the worker first. The
sharded and multi-host trainers (a world of one gloo rank), the per-step
path, evaluate and predict pack on the calling thread. The spans: the
worker's under `stage.worker` on its own thread, `stage.wire_wait` only
where a wire was late, and distinct span indices under threads that
switch often. Small DeepFM (dim 8, hidden (16,), batch 64, a new-row cap
that rejects ids)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding import host_store
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
from monolith_tpu_torch.utils import tracing

torch.set_num_threads(1)

TIMEOUT = 60.0


class SerialTrainer(Trainer):
    """The serial pack: every step of a block packed on the calling
    thread before the block dispatches."""

    def _stage_overlaps(self) -> bool:
        return False


def make(cls=Trainer, K=4, **engine):
    return cls(DeepFMTask(embedding_dim=8, capacity_per_shard=4096,
                          hidden=(16,), init_scale=0.3),
               TrainerConfig(engine=EngineConfig(
                   unique_cap=512, new_cap=48, record_touch=True, **engine),
                   log_every=0, seed=3, clip_norm=0.05,
                   steps_per_dispatch=K), device="cpu")


def batches(n, seed=4):
    data = SyntheticCTR(num_users=300, num_items=200, batch_size=64,
                        seed=seed)
    return [data.batch() for _ in range(n)]


def packs_by_thread(tr):
    """Wrap the trainer's pack: a list of (step, thread) per pack."""
    seen = []
    real = tr._pack_full_wire

    def pack(fid_batch, batch, layout, ts, stepno, out):
        seen.append((stepno, threading.get_ident()))
        return real(fid_batch, batch, layout, ts, stepno, out)
    tr._pack_full_wire = pack
    return seen


def slowed(tr, steps, seconds):
    """Make the pack of each step in `steps` sleep first when it runs off
    the calling thread."""
    real = tr._pack_full_wire
    main = threading.get_ident()

    def pack(fid_batch, batch, layout, ts, stepno, out):
        if stepno in steps and threading.get_ident() != main:
            time.sleep(seconds)
        return real(fid_batch, batch, layout, ts, stepno, out)
    tr._pack_full_wire = pack


def stores(tr):
    """Each host store's (fids, rows, timestamps, counts), by fid."""
    out = {}
    for t in tr.engine.tables:
        fids, rows, tss, counts = tr.engine.store_of(t).save()
        order = np.argsort(fids)
        out[t] = [np.asarray(a)[order] for a in (fids, rows, tss, counts)]
    return out


def assert_same_stores(a, b):
    sa, sb = stores(a), stores(b)
    assert sa.keys() == sb.keys()
    for t in sa:
        for x, y in zip(sa[t], sb[t]):
            np.testing.assert_array_equal(x, y, err_msg=t)


def assert_same_state(a, b):
    for t in a.table_states:
        assert torch.equal(a.table_states[t]["data"],
                           b.table_states[t]["data"]), t
    pa, pb = dict(a.module.named_parameters()), dict(b.module.named_parameters())
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(a.opt_state[n], b.opt_state[n]), n
    assert_same_stores(a, b)
    assert a.step == b.step


def assert_same_out(a, b):
    assert torch.equal(a["loss"], b["loss"])
    assert torch.equal(a["preds"], b["preds"])
    assert a["stats"] == b["stats"]


def worker_idle(tr):
    """No block of the trainer in the worker's hands."""
    return tr._prepared is None


@pytest.mark.parametrize("K", [4, 8])
def test_overlapped_block_equals_the_serial_pack(K):
    """A staged block, then an unstaged one: steps 1..K-1 of each packed
    on the worker, in order, and everything equal to the serial pack's."""
    data = batches(1 + 2 * K)
    over, serial = make(K=K), make(SerialTrainer, K=K)
    seen = packs_by_thread(over)
    outs = {}
    for name, tr in (("over", over), ("serial", serial)):
        tr.train_step(*data[0], ts=20)
        staged = tr.stage_block(data[1:1 + K], ts=21)
        first = tr.train_step_block(data[1:1 + K], staged=staged)
        second = tr.train_step_block(data[1 + K:], ts=22)
        outs[name] = (staged["wires"].clone(), first, second)
        assert worker_idle(tr)
    assert torch.equal(outs["over"][0], outs["serial"][0])
    for a, b in zip(outs["over"][1:], outs["serial"][1:]):
        assert_same_out(a, b)
    assert_same_state(over, serial)
    main = threading.get_ident()
    assert [s for s, _ in seen] == list(range(1 + 2 * K))
    for blk in (1, 1 + K):
        assert seen[blk][1] == main
        assert {t for _, t in seen[blk + 1:blk + K]} - {main}
        assert all(t != main for _, t in seen[blk + 1:blk + K])
    assert serial._worker is None and over._worker is not None


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "async"])
def test_train_groups_equal_the_serial_pack(monkeypatch, stale):
    """One step, then `train(steps=10)` in groups of 4, 4 and 2, each a
    staged block: the hooks' outputs and the state equal the serial
    pack's, synchronous and 1-step-stale (the clock that stamps the ids
    held still)."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    data = batches(11)
    outs = {}
    trainers = {"over": make(async_optimize=stale),
                "serial": make(SerialTrainer, async_optimize=stale)}
    for name, tr in trainers.items():
        tr.train_step(*data[0], ts=5)
        got = []
        tr.train(iter(data[1:]), steps=10,
                 hooks=[lambda t, out: got.append((t.step, out))])
        assert [s for s, _ in got] == [5, 9, 11]
        outs[name] = [o for _, o in got]
    for a, b in zip(outs["over"], outs["serial"]):
        assert_same_out(a, b)
    assert_same_state(trainers["over"], trainers["serial"])


def test_hook_stop_leaves_the_store_as_the_per_step_loop(monkeypatch):
    """A hook's StopIteration after block 2 leaves the host store (and the
    rest of the state) as the per-step loop's after the same 8 steps: no
    step of block 3 was packed."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    data = batches(16)

    def stop_at(n):
        def hook(tr, out):
            if tr.step >= n:
                raise StopIteration
        return hook
    blocked, per_step = make(K=4), make(K=1)
    packs = packs_by_thread(blocked)
    for tr in (blocked, per_step):
        tr.train(iter(data), steps=None, hooks=[stop_at(8)])
    assert blocked.step == per_step.step == 8
    assert max(s for s, _ in packs) == 7
    assert_same_state(blocked, per_step)
    assert worker_idle(blocked)


@pytest.mark.parametrize("j", [1, 3])
def test_failed_prepare_stops_its_block(monkeypatch, j):
    """The native prepare of step j raises: the exception reaches the
    caller, no later prepare ran (the store is as after steps 0..j-1's
    prepares), and the worker holds nothing afterwards."""
    data = batches(5)
    tr, ref = make(), make(SerialTrainer)
    for t in (tr, ref):
        t.train_step(*data[0], ts=8)
    calls = []
    real = host_store.prepare_wire_multi

    def failing(*args, **kwargs):
        calls.append(threading.get_ident())
        if len(calls) == 1 + j:
            raise RuntimeError("prepare failed")
        return real(*args, **kwargs)
    monkeypatch.setattr(host_store, "prepare_wire_multi", failing)
    with pytest.raises(RuntimeError, match="prepare failed"):
        tr.train_step_block(data[1:], ts=9)
    assert len(calls) == 1 + j
    assert worker_idle(tr)
    time.sleep(0.2)
    assert len(calls) == 1 + j
    monkeypatch.setattr(host_store, "prepare_wire_multi", real)
    for fb, _ in data[1:1 + j]:
        ref.engine.prepare_wire(fb, ts=9)
    assert_same_stores(tr, ref)


def test_failed_dispatch_joins_the_worker(monkeypatch):
    """Step 1 of a block raises in its dispatch while the worker is slowed:
    train_step_block returns its exception only after the worker has
    finished the block, which leaves the store as the serial pack's of
    all K steps."""
    data = batches(5)
    tr, ref = make(), make(SerialTrainer)
    for t in (tr, ref):
        t.train_step(*data[0], ts=8)
    slowed(tr, {2, 3, 4}, 0.05)
    real = Trainer._step_core

    def core(self, inputs, batch_t, step):
        if step == 2:
            raise RuntimeError("dispatch failed")
        return real(self, inputs, batch_t, step)
    monkeypatch.setattr(Trainer, "_step_core", core)
    with pytest.raises(RuntimeError, match="dispatch failed"):
        tr.train_step_block(data[1:], ts=9)
    assert worker_idle(tr)
    for fb, _ in data[1:]:
        ref.engine.prepare_wire(fb, ts=9)
    assert_same_stores(tr, ref)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        from monolith_tpu_torch.parallel import make_mesh
        yield make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["sharded", "multihost"])
def test_sharded_trainers_pack_on_the_calling_thread(world_of_one, kind):
    """At a world of one gloo rank, blocks of 4 through `train`, evaluate
    and predict: every pack on the calling thread, no worker started."""
    from monolith_tpu_torch.parallel import MultiHostTrainer, ShardedTrainer
    cls = MultiHostTrainer if kind == "multihost" else ShardedTrainer
    tr = cls(DeepFMTask(embedding_dim=8, capacity_per_shard=4096,
                        hidden=(16,)),
             TrainerConfig(engine=EngineConfig(num_shards=1, unique_cap=512,
                                               new_cap=512),
                           log_every=0, steps_per_dispatch=4),
             world_of_one)
    assert not tr._stage_overlaps()
    seen = packs_by_thread(tr)
    data = batches(10)
    tr.train(iter(data[:8]), steps=8)
    tr.evaluate(iter(data[8:9]))
    tr.predict(*data[9])
    assert tr.step == 8 and len(seen) == 10
    assert {t for _, t in seen} == {threading.get_ident()}
    assert tr._worker is None


def test_per_step_path_evaluate_and_predict_pack_on_the_calling_thread():
    data = batches(6)
    tr = make(K=1)
    seen = packs_by_thread(tr)
    tr.train(iter(data[:4]), steps=4)
    tr.evaluate(iter(data[4:5]))
    tr.predict(*data[5])
    assert len(seen) == 6
    assert {t for _, t in seen} == {threading.get_ident()}
    assert tr._worker is None


def test_spans_of_the_worker_and_the_late_wire():
    """An overlapped `train()` of two blocks of 4, step 6's pack slowed on
    the worker: prepares on two threads; the worker's under its
    `stage.worker`, never under a span of the calling thread; every index
    distinct; a `stage.wire_wait` for step 6, and one only where the wire
    was not packed when its step took it."""
    tr = make()
    slowed(tr, {6}, 0.3)
    with tracing.recording() as rec:
        tr.train(iter(batches(8)), steps=8)
    spans = rec.spans
    assert len(spans) == rec._n and rec.dropped == 0
    main = threading.get_ident()
    prep = [s for s in spans if s.name == "stage.prepare"]
    assert sorted(s.step for s in prep) == list(range(8))
    assert {s.thread for s in prep if s.step in (0, 4)} == {main}
    assert {s.thread for s in prep if s.step not in (0, 4)} - {main}
    for s in spans:
        if s.thread != main and s.name != "host.gc":
            top = s
            while top.parent >= 0:
                assert spans[top.parent].thread == s.thread
                top = spans[top.parent]
            assert top.name == "stage.worker"
    # a wire is handed over just after its pack's last span ends
    packed = {s.step: s.end for s in spans if s.name == "stage.copy_batch"}
    waits = {s.step: s for s in spans if s.name == "stage.wire_wait"}
    assert waits[6].start < packed[6]
    for step, w in waits.items():
        assert w.thread == main and step not in (0, 4)
        assert packed[step] <= w.end
    decode = {s.step: s.start for s in spans if s.name == "step.decode"}
    for step in set(range(8)) - set(waits):
        assert packed[step] <= decode[step]


def test_span_indices_stay_distinct_under_threads():
    """16 threads open spans at once, the switch interval shortened: every
    span is kept, under its own index, with its own thread's parent."""
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work(k):
                with tracing.span("outer", k):
                    for i in range(per):
                        with tracing.span("inner", i):
                            pass
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    kept = rec.spans
    spans = [s for s in kept if s.name != "host.gc"]
    assert rec._n == len(kept)
    assert len(spans) == n_threads * (per + 1)
    assert sorted(s.step for s in spans if s.name == "outer") == list(
        range(n_threads))
    for s in spans:
        if s.name == "inner":
            p = kept[s.parent]
            assert p.name == "outer" and p.thread == s.thread
    steps = {}
    for s in spans:
        if s.name == "inner":
            steps.setdefault(s.parent, []).append(s.step)
    assert len(steps) == n_threads
    assert all(v == list(range(per)) for v in steps.values())


def test_wide_wire_block_is_packed_by_the_worker():
    """A table whose unique cap is above 65535 rides the wire with int32
    index words: its staged block's steps 1..K-1 are packed on the worker,
    and the wires, outputs and state are the serial pack's byte for
    byte."""
    K = 4
    data = batches(1 + K)
    wide = dict(unique_caps=(("sparse", 70000),))
    over, serial = make(K=K, **wide), make(SerialTrainer, K=K, **wide)
    assert over.engine.wide("sparse") and over._stage_overlaps()
    seen = packs_by_thread(over)
    outs = {}
    for name, tr in (("over", over), ("serial", serial)):
        tr.train_step(*data[0], ts=20)
        staged = tr.stage_block(data[1:], ts=21)
        out = tr.train_step_block(data[1:], staged=staged)
        outs[name] = (staged["wires"].clone(), out)
        assert worker_idle(tr)
    assert torch.equal(outs["over"][0], outs["serial"][0])
    assert outs["over"][0].shape[1] > 70000 + 64 * (1 + 1 + 10)
    assert_same_out(outs["over"][1], outs["serial"][1])
    assert_same_state(over, serial)
    main = threading.get_ident()
    assert [s for s, _ in seen] == list(range(1 + K))
    assert seen[1][1] == main
    assert all(t != main for _, t in seen[2:])

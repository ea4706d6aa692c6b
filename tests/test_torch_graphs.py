"""The training step's captured CUDA graphs (monolith_tpu_torch/training/
graphs.py) on the CPU, where no graph can be captured:

- `Trainer._graph_capable()`: False on the CPU; on a CUDA-typed device
  True for the plain DeepFM and DLRM-DCNv2 trainers, False for the
  sharded and multi-host trainers (a world of one gloo rank), a module
  with drawing layers, one with batch statistics and a table with a
  retriever;
- DLRM-DCNv2's `graph_parts` are exactly the submodules its spans wrap;
- the trainer's side of the graphs with the card's capture emulated
  (`cpu_graphs`: a replay runs the captured piece again on its static
  inputs and writes its static outputs and gradient buffers in place, the
  backward from a recomputed forward): DeepFM and DLRM-DCNv2 blocks,
  synchronous and 1-step-stale, equal to an eager trainer bit for bit;
  the pieces (pool first, then the tower's parts in the order they run;
  a tower graphed whole reads the pool's outputs and hands it its
  gradients in place); predictions that are the tower's own output
  survive the next replay; the counters; a batch of another size steps
  eager; a rebound parameter drops the graphs; a refused capture steps
  eager for good. The card's own captures are in
  tests/test_torch_cuda.py.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from monolith_tpu_torch import layers
from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding import retrievers
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMModule, DeepFMTask
from monolith_tpu_torch.models.dlrm_dcnv2 import DLRMDCNv2Task
from monolith_tpu_torch.training import graphs
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig
from monolith_tpu_torch.utils import tracing

torch.set_num_threads(1)

CUDA = torch.device("cuda")


def deepfm_task(**kw):
    return DeepFMTask(embedding_dim=8, capacity_per_shard=4096, hidden=(16,),
                      init_scale=0.3, **kw)


def dcnv2_task():
    return DLRMDCNv2Task(rows=(50, 300, 40), hotness=(1, 2, 3),
                         embedding_dim=8, bottom=(16, 8), top=(16, 8, 1),
                         cross_layers=2, cross_rank=4)


def config(K=4, **engine):
    return TrainerConfig(engine=EngineConfig(unique_cap=512, new_cap=512,
                                             **engine),
                         log_every=0, seed=3, clip_norm=0.05,
                         steps_per_dispatch=K)


def deepfm_batches(n, batch_size=64, seed=4):
    data = SyntheticCTR(num_users=300, num_items=200, batch_size=batch_size,
                        seed=seed)
    return [data.batch() for _ in range(n)]


def dcnv2_batches(n, batch_size=64, seed=4):
    rng = np.random.default_rng(seed)
    task = dcnv2_task()
    out = []
    for _ in range(n):
        fids = {f: rng.integers(0, rows, (batch_size, hot)).astype(np.int64)
                for f, rows, hot in zip(task.feature_names, task.rows,
                                        task.hotness)}
        out.append((fids, {
            "dense": rng.random((batch_size, task.num_dense),
                                dtype=np.float32),
            "label": rng.integers(0, 2, batch_size).astype(np.float32)}))
    return out


MODELS = {"deepfm": (deepfm_task, deepfm_batches),
          "dcnv2": (dcnv2_task, dcnv2_batches)}


def on_card(tr):
    """The trainer as `_graph_capable` sees it on a card: the device is
    read there and nowhere else."""
    tr.device = CUDA
    return tr


# ----------------------------------------------------------------------
# eligibility
# ----------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
def test_plain_trainers_are_capable_on_the_card_only(model):
    tr = Trainer(MODELS[model][0](), config(), device="cpu")
    assert not tr._graph_capable()
    assert on_card(tr)._graph_capable()


class _WithLayer(nn.Module):
    """DeepFM's tower beside a layer that its forward does not call."""

    def __init__(self, inner, extra):
        super().__init__()
        self.inner, self.extra = inner, extra

    def forward(self, pooled, batch=None):
        return self.inner(pooled, batch)


@dataclasses.dataclass
class _ExtraLayerTask(DeepFMTask):
    extra: str = "draws"

    def build_module(self, generator=None):
        inner = DeepFMModule(self.embedding_dim, tuple(self.hidden),
                             generator=generator)
        width = 3 * self.embedding_dim
        extra = (layers.DCN(width, use_dropout=True, keep_prob=0.9,
                            generator=generator)
                 if self.extra == "draws" else layers.BatchNorm(width))
        return _WithLayer(inner, extra)


@pytest.mark.parametrize("extra", ["draws", "batch_stats"])
def test_drawing_layers_and_batch_statistics_are_not_capable(extra):
    tr = on_card(Trainer(_ExtraLayerTask(
        embedding_dim=8, capacity_per_shard=4096, hidden=(16,), extra=extra),
        config(), device="cpu"))
    assert (tr._draws is not None) == (extra == "draws")
    assert bool(tr.model_state) == (extra == "batch_stats")
    assert not tr._graph_capable()


@dataclasses.dataclass
class _RetrieverTask(DeepFMTask):
    def tables(self):
        return [dataclasses.replace(t, segments=(
            t.segments[0], dataclasses.replace(
                t.segments[1], retriever=retrievers.FakeQuant())))
                for t in super().tables()]


def test_a_retriever_is_not_capable():
    tr = on_card(Trainer(_RetrieverTask(embedding_dim=8,
                                        capacity_per_shard=4096,
                                        hidden=(16,)), config(), device="cpu"))
    assert not tr._graph_capable()


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
def test_sharded_trainers_are_not_capable(world_of_one, kind):
    """ShardedTrainer's override refuses (its seams run collectives) where
    the Trainer's rules alone would admit the same trainer."""
    from monolith_tpu_torch.parallel import MultiHostTrainer, ShardedTrainer
    cls = MultiHostTrainer if kind == "multihost" else ShardedTrainer
    tr = on_card(cls(deepfm_task(), config(num_shards=1), world_of_one))
    assert not tr._graph_capable()
    assert Trainer._graph_capable(tr)


def test_dcnv2_parts_are_the_submodules_its_spans_wrap():
    """Each child of the module called inside the forward, by the innermost
    span open at the call: `graph_parts` names them, in order, and each
    alone in its span."""
    import time
    task = dcnv2_task()
    module = task.build_module(torch.Generator().manual_seed(0))
    calls = []
    for name, child in module.named_children():
        child.register_forward_pre_hook(
            lambda m, a, name=name: calls.append((name, time.perf_counter())))
    fids, batch = dcnv2_batches(1)[0]
    pooled = {f: torch.randn(64, task.embedding_dim)
              for f in task.feature_names}
    with tracing.recording() as rec:
        module(pooled, {k: torch.from_numpy(v) for k, v in batch.items()})
    spans = [s for s in rec.spans if s.name.startswith("step.")]

    def innermost(t):
        return max((s.start, s.name) for s in spans if s.start <= t <= s.end)[1]
    assert [(innermost(t), n) for n, t in calls] == [
        ("step.bottom", "bottom"), ("step.cross", "cross"),
        ("step.top", "top")]
    assert module.graph_parts == ("bottom", "cross", "top")
    assert getattr(DeepFMModule, "graph_parts", None) is None


# ----------------------------------------------------------------------
# the trainer's side, with the card's capture emulated
# ----------------------------------------------------------------------

class Graphed(Trainer):
    """A CPU trainer that takes the graphed path."""

    def _graph_capable(self):
        return True


class Eager(Trainer):
    def _graph_capable(self):
        return False


class _CpuGraph:
    def __init__(self, run):
        self.replay = run


def _capture_forward(self, pool):
    self.outputs, self.spec = tree_flatten(self.fn(*self.args))
    outs = self.outputs

    def run():
        with torch.no_grad():
            for o, n in zip(outs, tree_leaves(self.fn(*self.args))):
                o.copy_(n)
    self.fwd = _CpuGraph(run)
    return outs


def _capture_backward(self, pool, grad_outputs=None):
    if grad_outputs is None:
        grad_outputs = [torch.empty_like(o) if o.requires_grad else None
                        for o in self.outputs]
    self.grad_outputs = grad_outputs
    self.grad_inputs = [None] * len(self.inputs)
    wrt = [i for i, x in enumerate(self.inputs) if x.requires_grad]
    wants = [x.requires_grad for x in tree_leaves(self.args)]

    def grads():
        with torch.enable_grad():
            leaves, spec = tree_flatten(self.args)
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(leaves, wants)]
            args = tree_unflatten(leaves, spec)
            xs = leaves + list(self.params)
            total = sum((o * g).sum() for o, g in zip(
                tree_leaves(self.fn(*args)), self.grad_outputs)
                if g is not None)
            return torch.autograd.grad(total, [xs[i] for i in wrt],
                                       allow_unused=True)
    for i, g in zip(wrt, grads()):
        self.grad_inputs[i] = g
    static = [self.grad_inputs[i] for i in wrt]

    def run():
        for s, g in zip(static, grads()):
            if s is not None:
                s.copy_(g)
    self.bwd = _CpuGraph(run)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The card's capture emulated on the CPU; each capture's pieces
    kept."""
    captures = []

    def prepare(pieces):
        captures.append(pieces)
        for p in pieces:
            p.warm()
    monkeypatch.setattr(graphs, "_prepare", prepare)
    monkeypatch.setattr(graphs._Piece, "capture_forward", _capture_forward)
    monkeypatch.setattr(graphs._Piece, "capture_backward", _capture_backward)
    return captures


def run_blocks(tr, batches, K=4):
    """Step 0 alone, then blocks of K; (losses, preds) as numpy."""
    outs = [tr.train_step(*batches[0], ts=5)]
    for i in range(1, len(batches), K):
        pairs = batches[i:i + K]
        outs.append(tr.train_step_block(pairs, ts=6,
                                        staged=tr.stage_block(pairs, ts=6)))
    losses = np.concatenate([o["loss"].reshape(-1).numpy() for o in outs])
    preds = np.concatenate([o["preds"].reshape(-1).numpy() for o in outs])
    return losses, preds


def assert_same_state(a, b):
    for (n, p), (_, q) in zip(a.module.named_parameters(),
                              b.module.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a.opt_state[n], b.opt_state[n]), n
    for t in a.table_states:
        for x, y in zip(tree_leaves(a.table_states[t]),
                        tree_leaves(b.table_states[t])):
            assert torch.equal(x, y), t


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_graphed_blocks_equal_eager_blocks(cpu_graphs, model, stale):
    make_task, make_batches = MODELS[model]
    batches = make_batches(9)
    eager = Eager(make_task(), config(async_optimize=stale), device="cpu")
    graphed = Graphed(make_task(), config(async_optimize=stale),
                      device="cpu")
    want = run_blocks(eager, batches)
    with tracing.recording() as rec:
        got = run_blocks(graphed, batches)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert_same_state(graphed, eager)
    assert len(cpu_graphs) == 1 and isinstance(graphed._graphs,
                                               graphs.StepGraphs)
    counts = rec.counter_totals()
    assert counts["graph.eager"] == (1, 1) and counts["graph.replay"] == (8, 8)
    assert counts["graph.capture"][0] == 1

    # the pool first, then the tower's parts in the order they run, each
    # with its module's parameters; static inputs of their own, the index
    # matrices stacked by shape, the leaves requiring grad
    pool, *tower = cpu_graphs[0]
    names = getattr(graphed.module, "graph_parts", None)
    params = ([list(graphed.module.parameters())] if names is None else
              [list(getattr(graphed.module, n).parameters()) for n in names])
    assert [list(p.params) for p in tower] == params and pool.params == ()
    leaves, index = pool.args
    assert sorted(leaves) == sorted(graphed.engine.tables)
    n_index = sum(len(f) for f in graphed.engine.table_features.values())
    # deepfm: user_id and item_id [B, 1], hist_items [B, 10]; dcnv2: one
    # hotness a table
    assert sum(len(i) for i in index) == n_index
    assert len(index) == {"deepfm": 2, "dcnv2": 3}[model]
    if names is None:
        # the tower reads the pool's outputs, and hands it its gradients,
        # in place
        assert [t.data_ptr() for t in tower[0].args[0]] == [
            o.data_ptr() for o in pool.outputs]
        assert all(g is t for g, t in zip(pool.grad_outputs,
                                          tower[0].grad_inputs))
    # the module's children are its own again after every replay
    assert all(not isinstance(m, graphs._Swap)
               for m in graphed.module.modules())


@dataclasses.dataclass
class _LogitsTask(DeepFMTask):
    """Predictions that are the tower's output itself."""

    def predictions(self, outputs):
        return outputs["logits"]


def test_predictions_survive_the_next_replay(cpu_graphs):
    kw = dict(embedding_dim=8, capacity_per_shard=4096, hidden=(16,))
    batches = deepfm_batches(9)
    want = run_blocks(Eager(_LogitsTask(**kw), config(), device="cpu"),
                      batches)
    got = run_blocks(Graphed(_LogitsTask(**kw), config(), device="cpu"),
                     batches)
    np.testing.assert_array_equal(got[1], want[1])
    rows = got[1].reshape(9, -1)
    assert all(not np.array_equal(rows[i], rows[j])
               for i in range(9) for j in range(i))


def test_a_batch_of_another_size_steps_eager(cpu_graphs):
    tr = Graphed(deepfm_task(), config(), device="cpu")
    small = deepfm_batches(1, batch_size=32, seed=5)[0]
    with tracing.recording() as rec:
        tr.train_step(*deepfm_batches(1)[0], ts=1)
        tr.train_step(*small, ts=1)
        tr.train_step(*deepfm_batches(1, seed=6)[0], ts=1)
    steps = [(c.name, c.step) for c in rec.counters
             if c.name.startswith("graph.") and c.name != "graph.capture"]
    assert steps == [("graph.eager", 0), ("graph.eager", 1),
                     ("graph.replay", 2)]
    assert len(cpu_graphs) == 1


def test_a_rebound_parameter_drops_the_graphs(cpu_graphs):
    tr = Graphed(deepfm_task(), config(), device="cpu")
    data = deepfm_batches(3)
    tr.train_step(*data[0], ts=1)
    first = tr._graphs
    assert first.holds(tr.module)
    p = next(tr.module.parameters())
    p.data = p.data.clone()
    assert not first.holds(tr.module)
    with tracing.recording() as rec:
        tr.train_step(*data[1], ts=1)
        tr.train_step(*data[2], ts=1)
    assert [c.name for c in rec.counters if c.name.startswith("graph.")
            ] == ["graph.eager", "graph.capture", "graph.replay"]
    assert tr._graphs is not first and tr._graphs.holds(tr.module)
    assert len(cpu_graphs) == 2


def test_a_refused_capture_steps_eager_for_good(monkeypatch):
    def refuse(pieces):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(graphs, "_prepare", refuse)
    data = deepfm_batches(5)
    tr = Graphed(deepfm_task(), config(), device="cpu")
    eager = Eager(deepfm_task(), config(), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with tracing.recording() as rec:
            got = run_blocks(tr, data)
    assert tr._graphs is False
    assert any("its capture failed" in str(w.message) for w in caught)
    assert [c.name for c in rec.counters
            if c.name.startswith("graph.")] == ["graph.eager"] * 5
    for w, g in zip(run_blocks(eager, data), got):
        np.testing.assert_array_equal(g, w)


def test_outputs_that_alias_the_towers_are_cloned():
    out = {"logits": torch.arange(4.0)}
    preds = out["logits"][1:]
    loss, aux = torch.ones(()), {"x": out["logits"].view(2, 2)}
    got_loss, got_preds, got_aux = graphs.StepGraphs.own(
        (loss, preds, aux), out)
    assert got_loss is loss
    assert torch.equal(got_preds, preds) and torch.equal(got_aux["x"],
                                                         aux["x"])
    static = out["logits"].untyped_storage().data_ptr()
    assert got_preds.untyped_storage().data_ptr() != static
    assert got_aux["x"].untyped_storage().data_ptr() != static


@pytest.mark.parametrize("shapes", [[(3, 1)] * 4, [(3, 1), (3, 2), (3, 1),
                                                  (2, 2), (3, 2)]])
def test_stacks_round_trip(shapes):
    tensors = [torch.randn(s) for s in shapes]
    st = graphs._Stacks(tensors)
    stacks = st.stack(tensors)
    assert len(stacks) == len(set(shapes))
    for a, b in zip(st.unstack(stacks), tensors):
        assert torch.equal(a, b)
    out = [torch.empty_like(s) for s in stacks]
    st.stack([t + 1 for t in tensors], out=out)
    for a, b in zip(st.unstack(out), tensors):
        assert torch.equal(a, b + 1)

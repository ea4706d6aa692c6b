"""The training step's autograd region as captured CUDA graphs.

The region runs from the unique rows the lookup returns to the gradients
the apply takes (`Trainer._dense_step`): the pooling, the tower's forward
and the backward of both. Every shape in it is fixed by the configuration
(the padded unique cap, the index matrices [B, L], the batch), and none of
its inputs is read on the host, so it is captured once and replayed at
every step after that; the lookup, the loss, the dense update, the
metrics, the apply and the decode stay eager.

Parts, one per program span that opens around them, each captured as a
forward graph and a backward graph (`_Piece`):

- pool (`step.pool`): `engine.pool_features` over the leaves {table: [U,
  dim]} (which require grad) and the step's index matrices.
- tower (`step.forward`): the module's forward, whole. A module that opens
  spans of its own inside its forward names the submodules its spans wrap
  in a tuple `graph_parts` (DLRMDCNv2Module: bottom, cross, top); each of
  them is graphed, and the forward itself stays eager, so that every
  replay runs inside its span.

A replay is one autograd node (`_Replay`): its forward copies the step's
tensors into the graph's static inputs and replays the forward graph; its
backward, run by `torch.autograd.grad` inside `step.backward`, copies the
incoming gradients into the static gradient buffers and replays the
backward graph. What crosses a boundary is kept to a few tensors: the
index matrices of one shape are stacked straight into the pool's static
input, and before a tower graphed whole the pool stacks its features of
one shape, so that the tower's static input is the pool's static output
and the pool's incoming gradient the tower's gradient buffer: a replay
copies nothing there. The backward graphs are captured from a scalar (the
sum of each output times its gradient buffer), whose gradient wrt each
output is that buffer bit for bit.

The first training step of an eligible trainer (`Trainer._graph_capable`)
runs eager, records what each tower part is called with (`Capture`), and
once its dense update is done (and its autograd graph dropped, whose
nodes belong to the default stream) captures the parts in the order they
run, in one memory pool, after a warm-up on a side stream. A later step
replays when its inputs have the captured names, shapes and dtypes
(`signature`) and the module's parameters are the captured tensors (loads
copy into them in place); any other step runs eager. A module whose part
is called other than once in its forward, or whose capture raises, steps
eager from then on.

Aliasing: a replay's outputs and input gradients are static buffers,
overwritten by the next replay. The loss, the predictions and the
auxiliary losses outlive the step: each is computed eagerly from the
tower's outputs, or cloned where it shares their storage (`own`). The
gradients wrt the unique rows are consumed inside the step, on the same
stream, and the 1-step-stale schedule's pending rows are computed from
them.

Counters (`tracing.count`, in the open recording): `graph.replay` (one a
step that replayed), `graph.eager` (one a step of an eligible trainer that
ran eager: the capture's own step, a change of shapes) and
`graph.capture` (one a capture, valued in seconds).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.autograd.function import once_differentiable
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

from monolith_tpu_torch.utils import tracing

#: eager passes of every part on a side stream before the capture, so that
#: lazy initialisation (library handles, workspaces) happens outside it
WARMUP = 3


def signature(unique: Dict[str, torch.Tensor], inputs: Dict,
              batch: Dict[str, torch.Tensor]) -> tuple:
    """What a replay needs to hold: the names, shapes and dtypes of the
    unique rows, of each table's index matrices and of the batch arrays,
    in their order."""
    return (tuple((t, u.shape, u.dtype) for t, u in unique.items()),
            tuple((t, tuple((f, i.shape, i.dtype)
                            for f, i in tin["index"].items()))
                  for t, tin in inputs.items()),
            tuple((k, v.shape, v.dtype) for k, v in batch.items()))


def _sample(t):
    """A tensor of the step as a sample argument: the capture's static
    input, so a copy of its own."""
    if not isinstance(t, torch.Tensor):
        return t
    return t.detach().clone().requires_grad_(t.requires_grad)


def _param_ptrs(module: nn.Module) -> tuple:
    return tuple(p.data_ptr() for p in module.parameters())


class _Stacks:
    """A list of tensors as one stack a (shape, dtype), in the order first
    seen: what crosses a graph's boundary as a few tensors, not one a
    feature."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        keys: List[tuple] = []
        self.where: List[Tuple[int, int]] = []     # (stack, row) a tensor
        for t in tensors:
            k = (t.shape, t.dtype)
            if k not in keys:
                keys.append(k)
            g = keys.index(k)
            self.where.append((g, sum(w[0] == g for w in self.where)))
        self.groups = [[i for i, (g, _) in enumerate(self.where) if g == k]
                       for k in range(len(keys))]

    def stack(self, tensors, out=None) -> List[torch.Tensor]:
        return [torch.stack([tensors[i] for i in group],
                            out=None if out is None else out[k])
                for k, group in enumerate(self.groups)]

    def unstack(self, stacks) -> List[torch.Tensor]:
        rows = [s.unbind(0) for s in stacks]
        return [rows[g][r] for g, r in self.where]


class _Replay(torch.autograd.Function):
    """One replay of a `_Piece` as an autograd node."""

    @staticmethod
    def forward(ctx, piece, *inputs):
        for s, x in zip(piece.static, inputs):
            if s.data_ptr() != x.data_ptr():
                s.copy_(x)
        piece.fwd.replay()
        ctx.piece = piece
        return tuple(o.detach() for o in piece.outputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        piece = ctx.piece
        for s, g in zip(piece.grad_outputs, grads):
            if s is not None and s.data_ptr() != g.data_ptr():
                s.copy_(g)
        piece.bwd.replay()
        return (None, *(None if g is None else g.detach()
                        for g in piece.grad_inputs))


class _Piece:
    """A function of tensors (and of a module's parameters, which get
    gradients) captured as a forward and a backward graph; its static
    inputs are the sample arguments it is built with."""

    def __init__(self, fn, args: tuple, params=()):
        self.fn, self.args, self.params = fn, args, tuple(params)

    @property
    def inputs(self) -> List[torch.Tensor]:
        return tree_leaves(self.args) + list(self.params)

    def warm(self) -> None:
        outs = [o for o in tree_leaves(self.fn(*self.args)) if o.requires_grad]
        wrt = [x for x in self.inputs if x.requires_grad]
        if outs and wrt:
            torch.autograd.grad(sum(o.sum() for o in outs), wrt,
                                allow_unused=True)

    def capture_forward(self, pool) -> List[torch.Tensor]:
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, pool=pool):
            out = self.fn(*self.args)
        self.outputs, self.spec = tree_flatten(out)
        return self.outputs

    def capture_backward(self, pool, grad_outputs=None) -> None:
        """`grad_outputs`: the gradient buffer of each output (another
        graph's static gradient, which this one then reads in place), or
        None for new ones."""
        outs = self.outputs
        if grad_outputs is None:
            grad_outputs = [torch.empty_like(o) if o.requires_grad else None
                            for o in outs]
        self.grad_outputs = grad_outputs
        inputs = self.inputs
        self.grad_inputs = [None] * len(inputs)
        wrt = [i for i, x in enumerate(inputs) if x.requires_grad]
        if not wrt or all(g is None for g in grad_outputs):
            return      # nothing to differentiate: no backward replays
        self.bwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.bwd, pool=pool):
            total = sum((o * g).sum() for o, g in zip(outs, grad_outputs)
                        if g is not None)
            grads = torch.autograd.grad(total, [inputs[i] for i in wrt],
                                        allow_unused=True)
        for i, g in zip(wrt, grads):
            self.grad_inputs[i] = g

    def drop_autograd(self) -> None:
        """Keep the static tensors only, not the capture's autograd graph
        (whose nodes belong to the capture's stream)."""
        self.outputs = [o.detach() for o in self.outputs]
        self.args = tree_map(lambda t: t.detach(), self.args)
        self.static = tree_leaves(self.args)

    def __call__(self, *args):
        out = _Replay.apply(self, *tree_leaves(args), *self.params)
        return tree_unflatten(list(out), self.spec)


class _Swap(nn.Module):
    """A graphed part in place of its submodule during the module's
    forward."""

    def __init__(self, piece: _Piece):
        super().__init__()
        self.piece = piece

    def forward(self, *args):
        return self.piece(*args)


class StepGraphs:
    """The captured parts of one trainer's step."""

    def __init__(self, sig: tuple, pool: _Piece, index: _Stacks,
                 keys: List[Tuple[str, str]], tower: List[_Piece],
                 names: Optional[Tuple[str, ...]], params: tuple):
        self.signature = sig
        self._pool, self._index, self._keys = pool, index, keys
        self._index_static = pool.args[1]
        self._tower = tower
        self._names = names
        self._swaps = None if names is None else [_Swap(p) for p in tower]
        self._params = params

    def holds(self, module: nn.Module) -> bool:
        """Whether the module's parameters are still the captured tensors."""
        return _param_ptrs(module) == self._params

    def pool(self, leaves: Dict[str, torch.Tensor], inputs: Dict):
        """The pooled features (stacked by shape before a tower graphed
        whole); the index matrices are stacked into the static input."""
        self._index.stack([inputs[t]["index"][f] for t, f in self._keys],
                          out=self._index_static)
        return self._pool(leaves, self._index_static)

    def forward(self, module: nn.Module, pooled, batch):
        """The tower's outputs: the graphed module, or the module's own
        forward with its graphed parts in place of its submodules."""
        if self._names is None:
            return self._tower[0](pooled, batch)
        children = module._modules
        held = [children[n] for n in self._names]
        children.update(zip(self._names, self._swaps))
        try:
            return module(pooled, batch)
        finally:
            children.update(zip(self._names, held))

    @staticmethod
    def own(tree, out):
        """`tree` (tensors that outlive the step) with every tensor that
        shares storage with the tower's outputs `out` cloned."""
        static = {t.untyped_storage().data_ptr() for t in tree_leaves(out)}
        return tree_map(
            lambda t: t.clone() if t.untyped_storage().data_ptr() in static
            else t, tree)


class Capture:
    """The eager step that captures: records the arguments each tower part
    is called with (`recording`), then captures every part (`finish`)."""

    def __init__(self, module: nn.Module, sig: tuple):
        self.module, self.signature = module, sig
        names = getattr(module, "graph_parts", None)
        self.names = tuple(names) if names else None
        self.parts = ([module] if self.names is None
                      else [getattr(module, n) for n in self.names])
        self.calls = [[] for _ in self.parts]

    @contextlib.contextmanager
    def recording(self):
        handles = [p.register_forward_pre_hook(self._recorder(i),
                                               with_kwargs=True)
                   for i, p in enumerate(self.parts)]
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    def _recorder(self, i: int):
        def record(_, args, kwargs):
            self.calls[i].append((tree_map(_sample, args), kwargs))
        return record

    def finish(self, engine, leaves: Dict[str, torch.Tensor], inputs: Dict,
               step: int) -> Union[StepGraphs, bool]:
        """The graphs, or False (with a warning) where this module's step
        cannot replay."""
        if any(len(c) != 1 or c[0][1] or not all(
                isinstance(a, torch.Tensor) for a in tree_leaves(c[0][0]))
               for c in self.calls):
            warnings.warn("the training step runs eager: a graphed part of "
                          "the module is called other than once, or with "
                          "keyword or other than tensor arguments, in its "
                          "forward")
            return False
        keys = [(t, f) for t, tin in inputs.items() for f in tin["index"]]
        index = _Stacks([inputs[t]["index"][f] for t, f in keys])
        whole = self.names is None
        if whole:
            pooled_s, batch_s = self.calls[0][0][0]
            names = list(pooled_s)
            stacked = _Stacks([pooled_s[n] for n in names])

        def pool(leaves, index_stacks):
            by_table: Dict[str, Dict[str, torch.Tensor]] = {}
            for (t, f), i in zip(keys, index.unstack(index_stacks)):
                by_table.setdefault(t, {})[f] = i
            # no retriever on an eligible trainer: the rows pool as they are
            out = engine.pool_features(
                leaves, {t: {"index": i} for t, i in by_table.items()})
            return stacked.stack([out[n] for n in names]) if whole else out
        pieces = [_Piece(pool, (tree_map(_sample, leaves), index.stack(
            [inputs[t]["index"][f] for t, f in keys])))]
        if whole:
            module = self.module
            pieces.append(_Piece(
                lambda stacks, batch: module(
                    dict(zip(names, stacked.unstack(stacks))), batch),
                ([_sample(s) for s in stacked.stack(
                    [pooled_s[n] for n in names])], batch_s),
                module.parameters()))
        else:
            pieces += [_Piece(p, c[0][0], p.parameters())
                       for p, c in zip(self.parts, self.calls)]
        t0 = time.perf_counter()
        try:
            _capture(pieces, chained=whole)
        except (RuntimeError, AssertionError) as e:  # the capture refused
            warnings.warn(f"the training step runs eager: its capture "
                          f"failed ({type(e).__name__}: {e})")
            return False
        tracing.count("graph.capture", time.perf_counter() - t0, step)
        return StepGraphs(self.signature, pieces[0], index, keys,
                          pieces[1:], self.names, _param_ptrs(self.module))


def _capture(pieces: List[_Piece], chained: bool) -> None:
    """Warm every piece up, then capture the forwards in order and the
    backwards in reverse, in one memory pool. `chained`: the
    second piece takes the first's outputs as its first argument (a tower
    graphed whole after the pool), in place and in both directions."""
    pool = _prepare(pieces)
    for i, p in enumerate(pieces):
        if chained and i == 1:
            p.args = (pieces[0].outputs,) + p.args[1:]
        p.capture_forward(pool)
    for i in reversed(range(len(pieces))):
        links = None
        if chained and i == 0:
            links = pieces[1].grad_inputs[:len(pieces[0].outputs)]
        pieces[i].capture_backward(pool, links)
    for p in pieces:
        p.drop_autograd()


def _prepare(pieces: List[_Piece]):
    """Warm every piece up on a side stream, the card idle before and
    after; returns a new memory pool for the captures."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            for p in pieces:
                p.warm()
    torch.cuda.current_stream().wait_stream(side)
    return torch.cuda.graph_pool_handle()


def recording(capture: Optional[Capture]):
    """The capture's recording of its parts' arguments; nothing without."""
    return contextlib.nullcontext() if capture is None else capture.recording()

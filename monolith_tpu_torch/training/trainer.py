"""Single-device trainer on the card (the port's `Trainer`).

Layers, from the entry point down:

  loop      `train` -> `_train_blocked`: batches in groups of K
            (`steps_per_dispatch`; 1 where blocks are not allowed), each
            group of two or more staged while the one before it
            dispatches, then the hooks and, at log steps, the metrics'
            readback. Exactly `steps` batches are read.
  stage     `stage_block` / `_pack_block`: the group's wires packed into
            one pinned int32 buffer [K, W] and uploaded; a step's wire
            (`_pack_full_wire`) is the engine's region (`engine.pack_step`:
            the host prepare), the batch arrays' raw 4-byte words and the
            step number. Where `_stage_overlaps`, the stage packs step 0
            and a second host thread, the stage worker, packs steps
            1..K-1 while the steps before them dispatch.
  dispatch  `train_step_block` (a group of K) and `train_step` (a group of
            one) run each step's one body, `_step`: decode
            (`engine.decode_step`), the revived rows attached, then the
            synchronous step (`_step_core`: `engine.lookup_step`, the dense
            step, `engine.apply_step`) or the 1-step-stale one
            (`_step_async`).
  dense     `_dense_step`: pooling, the tower's forward and backward, the
            global-norm clip, the dense optimizer and the metrics, on the
            card as captured CUDA graphs where `_graph_capable`
            (training/graphs.py).
  engine    embedding/engine.py: the one place that knows the step's wire
            format and table layout, and the kernels (K1 gather, K2
            scatter, K3 rounding) under it.

Three rules decide the paths, each a method that the sharded trainers
override:

  `_block_capable`   whether `train` runs blocks: on the fused wire
                     (`engine.fuse_wire`); a tiered or multi-array engine
                     steps one by one, as in the JAX package.
  `_stage_overlaps`  whether a block's steps 1..K-1 pack on the stage
                     worker: on the fused wire, whose pack is one native
                     call a step that releases the interpreter lock.
  `_graph_capable`   whether pooling and the tower run as captured CUDA
                     graphs: on the card, without drawing layers, model
                     state or retrievers.

With `EngineConfig.async_optimize` a block of packed tables runs the
1-step-stale schedule (`_step_async`): step i's forward gathers its rows
before step i-1's write-back has landed, the optimize runs on freshly
gathered rows so that no update is lost, and DC segments get the stale
rows to compensate.

A block equals its steps bit for bit on the CPU (the host's id -> row
mapping never depends on device values). The stage worker touches host
memory alone and packs in the serial pack's order, so its wires are the
serial pack's byte for byte; `train_step_block` returns (or raises) only
once the worker holds nothing. A staged block bakes in its step numbers
and admissions: it must be the next thing dispatched.

State is updated in place: the table pools by the K2 scatter, the dense
parameters and accumulators by the optimizer (the JAX program donates
them instead). Dense parameters come from a CPU generator seeded with
`config.seed`, so a trainer on the card and one on the CPU start alike.
The module runs in `train()` mode in training steps and in `eval()` mode
in `predict` and `evaluate`; its non-parameter state is `model_state`, in
flax's `{"batch_stats": ...}` form. Layers that draw (layers/draws.py)
draw from one generator seeded from (config.seed, step) before each
forward (the JAX trainer passes no `rngs`: ROADMAP fault R3). Loss and
AUC accumulate on the device and are read back only by `_drain_metrics`.

Expiry: `evict_expired` frees the expired ids' rows in the host stores
and zeroes them on the device; a tiered trainer `spill_expired`s them to
the host archive and revives them when their ids come back, the revived
rows uploaded beside the step's wire.

Spans (utils/tracing.py; kept only while a recording is open):
`train.fetch`, `train.stage` (`stage.wait`, per step `stage.prepare` and
`stage.copy_batch`, then `stage.upload`), `train.dispatch` holding a
`train.step` per step (a group of one has its `train.stage` and
`train.step` alone), each holding `step.decode`, `step.lookup`,
`step.pool`, `step.forward`, `step.backward`, `step.dense_update`,
`step.metrics` and `step.apply`, and `train.hooks`. The stage worker's
thread holds a `stage.worker` a block around the prepares and copies of
steps 1..K-1; a step whose wire is not packed when it needs it opens
`stage.wire_wait`. Counters `graph.replay`, `graph.eager` and
`graph.capture` say what each step's graphs did.

The sharded and multi-host trainers (parallel/) run these same steps on
each rank, with their own wires and six seams that are identities here:
`_exchange` / `_exchange_back` (the unique rows to and from the other
ranks), `_reduce_dense` (the ranks' mean of loss, dense gradients and
model state), `_gather` (the global predictions), `_mean` (an eval loss)
and `_barrier` (the ranks meet, around a checkpoint's or an export's
pointer).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from monolith_tpu_torch import convert
from monolith_tpu_torch.device import resolve_device
from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.embedding.engine import (EmbeddingEngine,
                                                 EngineConfig, _init_seed,
                                                 pad_rows)
from monolith_tpu_torch.layers.draws import set_generator
from monolith_tpu_torch.metrics import (StreamingAUC, StreamingMean,
                                        device_metrics_init,
                                        device_metrics_update)
from monolith_tpu_torch.ops.clip import clip_by_global_norm
from monolith_tpu_torch.training import graphs
from monolith_tpu_torch.training.task import RecTask
from monolith_tpu_torch.utils import tracing
from monolith_tpu_torch.utils.tracing import span

_WIRE_DTYPES = {np.dtype(np.float32).str: torch.float32,
                np.dtype(np.int32).str: torch.int32}


@dataclasses.dataclass
class TrainerConfig:
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    clip_norm: float = 0.0          # 0 = no dense grad clipping
    seed: int = 0
    log_every: int = 100
    # loss/AUC accumulate on the device every step and are read back only
    # at log prints and the end of train; False skips the accumulator
    metrics_enabled: bool = True
    # >1: train() packs and uploads this many steps at once and runs them
    # as one block (train_step_block); bit-identical to sequential steps
    steps_per_dispatch: int = 1


class _PinnedWires:
    """Two pinned host buffers [K, W] for the wires of K steps (K = 1: the
    per-step path), used in turn. A buffer is refilled only after the
    copies that last read it have finished (its CUDA event), so the host
    packs the next block while this block's copies may still be in
    flight."""

    def __init__(self, steps: int, words: int, device: torch.device):
        self.device = device
        pin = device.type == "cuda"
        self.bufs = [torch.empty((steps, words), dtype=torch.int32,
                                 pin_memory=pin) for _ in range(2)]
        self.events = [None, None]
        self.i = 0

    def host(self) -> np.ndarray:
        """The next buffer to fill, as a numpy view [K, W]."""
        if self.events[self.i] is not None:
            self.events[self.i].synchronize()
        return self.bufs[self.i].numpy()

    def upload(self) -> torch.Tensor:
        """Send the filled buffer to the device with one copy; returns the
        device copy [K, W]."""
        buf = self.bufs[self.i]
        if self.device.type == "cuda":
            wires = buf.to(self.device, non_blocking=True)
            self.events[self.i] = torch.cuda.Event()
            self.events[self.i].record()
        else:
            wires = buf.clone()
        self.i ^= 1
        return wires

    def upload_rows(self) -> Tuple[torch.Tensor, Callable[[int], None]]:
        """Send the buffer to the device row by row, as its rows are
        filled. Returns its device buffer [K, W], no row sent yet, and
        `send(r)`, which issues row r's copy on the current stream
        (non_blocking from the pinned row, so that a step launched after it
        reads it) and records the buffer's event after it, so that the
        event follows the last row sent."""
        buf = self.bufs[self.i]
        wires = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            event = self.events[self.i] = torch.cuda.Event()
        self.i ^= 1

        def send(r: int) -> None:
            wires[r].copy_(buf[r], non_blocking=cuda)
            if cuda:
                event.record()
        return wires, send


class _Prepares:
    """Steps 1..K-1 of one staged block, packed in order by the stage
    worker (`run`) into their rows of the pinned buffer while the calling
    thread dispatches the steps before them. `take(r)`, on the dispatching
    thread, waits for row r and sends it. A pack that raises ends the
    block there: `take` of that step raises its exception."""

    def __init__(self, pack, args: List[tuple], send: Callable[[int], None],
                 base: int):
        self.pack, self.args, self.send, self.base = pack, args, send, base
        self.ready = [threading.Event() for _ in range(len(args) + 1)]
        self.results: List[Optional[tuple]] = [None] * (len(args) + 1)
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        """The worker's side: host memory only, no CUDA call."""
        try:
            with span("stage.worker", self.base):
                for r, args in enumerate(self.args, 1):
                    try:
                        self.results[r] = self.pack(*args)
                    except BaseException as e:  # raised again by take(r)
                        self.error = e
                        return
                    finally:
                        self.ready[r].set()
        finally:
            self.pack = self.args = None

    def take(self, r: int) -> tuple:
        """Row r's (stats, revive) once its pack is done, its copy issued;
        a `stage.wire_wait` span while it is not."""
        if not self.ready[r].is_set():
            with span("stage.wire_wait", self.base + r):
                self.ready[r].wait()
        if self.results[r] is None:
            raise self.error
        self.send(r)
        return self.results[r]


class Trainer:
    """Owns engine host state, table pools, dense module and optimizer."""

    def __init__(self, task: RecTask, config: TrainerConfig = TrainerConfig(),
                 device=None):
        self.task = task
        self.config = config
        self.device = resolve_device(device)
        self.engine = EmbeddingEngine(task.tables(), task.features(),
                                      config.engine, seed=config.seed,
                                      device=self.device,
                                      shard=self._own_shard())
        generator = torch.Generator().manual_seed(config.seed)
        self.module = task.build_module(generator=generator).to(self.device)
        self._draws = torch.Generator(device=self.device)
        if not set_generator(self.module, self._draws):
            self._draws = None
        self.tx = task.dense_optimizer()
        self.opt_state = self.tx.init(self.module.named_parameters())
        self.table_states = self.engine.create_states()
        self.step = 0
        self.auc = StreamingAUC()
        self.loss_mean = StreamingMean()
        self._dev_metrics = None
        self._wires: Dict[tuple, _PinnedWires] = {}
        self._worker: Optional[ThreadPoolExecutor] = None
        self._prepared: Optional[Future] = None
        # the step's captured graphs; None until captured, False: never
        self._graphs = None

    def _own_shard(self) -> Optional[int]:
        """The table shard this trainer serves, for its engine (None: the
        single-device Trainer's whole table)."""
        return None

    # ------------------------------------------------------------------
    # the wire: engine region, batch arrays' 4-byte words, step number
    # ------------------------------------------------------------------

    @staticmethod
    def _batch_layout(batch) -> tuple:
        """Static (key, dtype, shape) tuple of the dense-side arrays."""
        items = []
        for k in sorted(batch):
            v = np.asarray(batch[k])
            if v.dtype.str not in _WIRE_DTYPES:
                raise ValueError(f"batch array {k!r} has dtype {v.dtype}; the "
                                 f"wire carries float32 and int32 arrays")
            items.append((k, v.dtype.str, v.shape))
        return tuple(items)

    def _full_wire_words(self, layout) -> int:
        return (self.engine.step_words(layout[0][2][0])
                + sum(int(np.prod(s)) for _, _, s in layout) + 1)

    def _pack_full_wire(self, fid_batch, batch, layout, ts, stepno, out):
        """Host side of _decode, into the int32 buffer `out` [W]. Returns
        (stats, revive): revive is None, or for a tiered engine the step's
        revived rows {table: (positions or rows, values)}, which travel
        beside the wire."""
        ew = self.engine.step_words(layout[0][2][0])
        with span("stage.prepare", stepno):
            stats, revive = self.engine.pack_step(fid_batch, ts, out[:ew])
        with span("stage.copy_batch", stepno):
            off = ew
            for k, _, shape in layout:
                n = int(np.prod(shape))
                out[off:off + n] = np.ascontiguousarray(
                    batch[k]).view(np.int32).ravel()
                off += n
            out[off] = stepno
        return stats, revive

    def _pack_block(self, pairs, ts: int, overlap: bool = False
                    ) -> Tuple[torch.Tensor, List, tuple, List,
                               Optional[_Prepares]]:
        """Pack K consecutive batches into one pinned [K, W] buffer and
        start its upload. Mutates the host stores (admission, row
        assignment) exactly like K sequential packs, and bakes in the step
        numbers self.step .. self.step + K - 1, so the result must be
        dispatched before any other step runs. Returns (wires [K, W] on the
        device, K stats, batch layout, K revives, prepares).

        Without `overlap` every step is packed here and the buffer goes in
        one non_blocking copy; prepares is None. With it (K >= 2,
        `_stage_overlaps`) only step 0 is packed here and its row sent;
        steps 1..K-1 are packed in order by the stage worker, and
        `prepares.take(r)` hands each to the dispatch, which fills in its
        stats and revive (None until then)."""
        self._join_prepares()
        if len(pairs) > 1 and not self._block_capable():
            raise ValueError("blocks need the fused wire: a trainer on "
                             "the multi-array path, and a tiered trainer "
                             "(its revived rows are taken from the archive "
                             "at each step's prepare), steps one by one")
        layout = self._batch_layout(pairs[0][1])
        if any(self._batch_layout(b) != layout for _, b in pairs[1:]):
            raise ValueError("the batches of a block must share one "
                             "layout (keys, dtypes, shapes)")
        words = self._full_wire_words(layout)
        key = (layout, len(pairs), words)
        if key not in self._wires:
            self._wires[key] = _PinnedWires(len(pairs), words, self.device)
        staging = self._wires[key]
        with span("stage.wait", self.step):
            host = staging.host()
        args = [(fb, b, layout, ts, self.step + i, host[i])
                for i, (fb, b) in enumerate(pairs)]
        n = 1 if overlap else len(args)
        packed = [self._pack_full_wire(*a) for a in args[:n]]
        stats = [p[0] for p in packed] + [None] * (len(args) - n)
        revives = [p[1] for p in packed] + [None] * (len(args) - n)
        with span("stage.upload", self.step):
            if not overlap:
                return staging.upload(), stats, layout, revives, None
            wires, send = staging.upload_rows()
            send(0)
        prepares = _Prepares(self._pack_full_wire, args[1:], send, self.step)
        if self._worker is None:    # the stage worker: one thread, lazily
            self._worker = ThreadPoolExecutor(1, "mt-stage")
        self._prepared = self._worker.submit(prepares.run)
        return wires, stats, layout, revives, prepares

    def _join_prepares(self) -> None:
        """Wait until the stage worker holds no block of this trainer, so
        that nothing else touches the host stores meanwhile."""
        prepared, self._prepared = self._prepared, None
        if prepared is not None:
            prepared.result()

    def _decode(self, wire: torch.Tensor, layout):
        """Device-side split of one step's wire [W]: the engine's region,
        then each batch array's raw 4-byte words (reinterpreted). The final
        word, the step number, stays unread: the host knows it. Returns
        (decoded engine inputs, batch tensors)."""
        bsz = layout[0][2][0]
        off = self.engine.step_words(bsz)
        inputs = self.engine.decode_step(wire[:off], bsz)
        batch_t = {}
        for k, dstr, shape in layout:
            n = int(np.prod(shape))
            batch_t[k] = wire[off:off + n].view(_WIRE_DTYPES[dstr]
                                                ).reshape(shape)
            off += n
        return inputs, batch_t

    def _upload(self, fid_batch, batch, ts):
        """Pack one step's wire and send it to the device; returns (decoded
        engine inputs, batch tensors, stats)."""
        wires, stats, layout, revives, _ = self._pack_block(
            [(fid_batch, batch)], ts)
        inputs, batch_t = self._decode(wires[0], layout)
        self._attach_revive(inputs, self._upload_revive(revives[0]))
        return inputs, batch_t, stats[0]

    def _attach_revive(self, inputs, revive) -> None:
        """Lay a step's uploaded revived rows ({table: (positions or rows,
        values)}, `_upload_revive`) into its decoded inputs, where the
        engine's layout takes them."""
        self.engine.attach_revive(inputs, revive)

    def _upload_revive(self, revive) -> Dict[str, Tuple[torch.Tensor,
                                                        torch.Tensor]]:
        """The revived rows of a step, every table's in ONE copy: its
        positions [m] int32 and values [m, width] f32 as the raw words of
        one int32 buffer. Returns {table: (positions, values)} on the
        device, for the tables that revive any row ({} for revive None)."""
        if revive is None:
            return {}
        parts, spans = [], []
        for tname, (pos, values) in sorted(revive.items()):
            if len(pos):
                parts += [pos, values.view(np.int32).ravel()]
                spans.append((tname, len(pos), values.shape[1]))
        if not parts:
            return {}
        words = torch.from_numpy(np.concatenate(parts)).to(self.device)
        out, off = {}, 0
        for tname, m, width in spans:
            out[tname] = (words[off:off + m], words[off + m:off + m + m * width]
                          .view(torch.float32).reshape(m, width))
            off += m + m * width
        return out

    # ------------------------------------------------------------------

    @property
    def model_state(self) -> Dict:
        """The module's non-parameter state in flax's form, numpy:
        {"batch_stats": tree} ({} for a module without)."""
        return convert.model_state_tree(self.module)

    def _forward(self, pooled, batch_t, step: int, training: bool,
                 graphed: Optional[graphs.StepGraphs] = None):
        """The module in train or eval mode (through the step's graphs when
        `graphed`), its drawing layers' generator seeded for `step`: the
        new-row init's seed domain at table index len(tables), which no
        table's init uses."""
        if self.module.training != training:
            self.module.train(training)
        if graphed is not None:
            return graphed.forward(self.module, pooled, batch_t)
        if self._draws is not None:
            self._draws.manual_seed(_init_seed(
                self.config.seed, step, len(self.engine.tables)))
        return self.module(pooled, batch_t)

    def _metrics_update(self, loss, preds, batch_t):
        """Accumulate the step's loss, and its AUC histograms when the
        batch has a "label" and the predictions are one tensor."""
        if not self.config.metrics_enabled:
            return
        if self._dev_metrics is None:
            self._dev_metrics = device_metrics_init(self.auc.num_thresholds,
                                                    self.device)
        label = batch_t.get("label")
        if label is not None and isinstance(preds, torch.Tensor):
            device_metrics_update(self._dev_metrics, loss, preds, label)
        else:
            device_metrics_update(self._dev_metrics, loss)

    def _dense_step(self, inputs, batch_t, unique, step: int):
        """Forward and backward on the gathered unique rows, the global-norm
        clip and the dense update. Returns (loss, preds, aux, gradients wrt
        the unique rows {table: [U, dim]}). Pooling and the tower replay
        their captured graphs where `_step_graphs` has them."""
        engine, task = self.engine, self.task
        graphed, capture = self._step_graphs(unique, inputs, batch_t, step)
        with span("step.pool", step):
            # differentiate wrt the gathered unique rows (after the
            # exchange, which stays outside autograd), not the pool
            leaves = {t: u.detach().requires_grad_()
                      for t, u in self._exchange(unique, inputs).items()}
            if graphed is not None:
                pooled = graphed.pool(leaves, inputs)
            else:
                pooled = engine.pool_features(
                    engine.retrieve_unique(leaves, step), inputs)
        with span("step.forward", step):
            with graphs.recording(capture):
                out = self._forward(pooled, batch_t, step, training=True,
                                    graphed=graphed)
            loss, aux = task.loss(out, batch_t)
        with span("step.backward", step):
            named = list(self.module.named_parameters())
            grads = torch.autograd.grad(
                loss, [p for _, p in named] + list(leaves.values()))
            gp = {name: g for (name, _), g in zip(named, grads)}
            gu = self._exchange_back(dict(zip(leaves, grads[len(named):])),
                                     inputs)
        with span("step.dense_update", step):
            loss, gp = self._reduce_dense(loss.detach(), gp)
            if self.config.clip_norm > 0:
                gp, _ = clip_by_global_norm(gp, self.config.clip_norm)
            self.tx.update_(named, gp, self.opt_state)
        with span("step.metrics", step):
            preds = self._gather(_detach(task.predictions(out)))
            self._metrics_update(loss, preds, batch_t)
        aux = _detach(aux)
        if graphed is not None:
            # what outlives the step must not be a graph's static buffer
            loss, preds, aux = graphed.own((loss, preds, aux), out)
        elif capture is not None:
            # the eager step's autograd graph goes first: its nodes run on
            # the default stream, which a capture's backward must not reach
            del out, pooled
            self._graphs = capture.finish(engine, leaves, inputs, step)
        return loss, preds, aux, gu

    def _step_graphs(self, unique, inputs, batch_t, step: int
                     ) -> Tuple[Optional[graphs.StepGraphs],
                                Optional[graphs.Capture]]:
        """(graphs to replay, capture to finish) of a training step: the
        graphs where they hold this step's shapes and the module's
        parameters; else the step runs eager, and the first step of an
        eligible trainer records its parts' arguments for the capture."""
        held = self._graphs
        if held is None and not self._graph_capable():
            return None, None
        if held and not held.holds(self.module):
            held = self._graphs = None      # a parameter was rebound
        sig = graphs.signature(unique, inputs, batch_t)
        if held and held.signature == sig:
            tracing.count("graph.replay", 1, step)
            return held, None
        tracing.count("graph.eager", 1, step)
        return None, (graphs.Capture(self.module, sig) if held is None
                      else None)

    # the sharded trainer's seams (parallel/sharded.py); identities here

    def _exchange(self, unique: Dict[str, torch.Tensor], inputs: Dict
                  ) -> Dict[str, torch.Tensor]:
        """The unique rows the step's index matrices address."""
        return unique

    def _exchange_back(self, grads: Dict[str, torch.Tensor], inputs: Dict
                       ) -> Dict[str, torch.Tensor]:
        """The gradients wrt this trainer's own unique rows."""
        return grads

    def _reduce_dense(self, loss: torch.Tensor, gp: Dict[str, torch.Tensor]):
        """(loss, dense gradients) of the whole batch."""
        return loss, gp

    def _gather(self, preds):
        """The predictions of the whole batch."""
        return preds

    def _mean(self, loss: torch.Tensor) -> torch.Tensor:
        """An eval loss of the whole batch."""
        return loss

    def _barrier(self) -> None:
        """Wait for every rank (checkpoints, exports): none here."""

    def _step_core(self, inputs, batch_t, step: int):
        """One synchronous training step on decoded inputs, shared by
        train_step and the synchronous block: gather (K1), forward and
        backward, dense update, row optimize and write-back (K2).
        Nothing here waits for the device. Returns (loss, preds, aux)."""
        engine, seed = self.engine, self.config.seed
        with span("step.lookup", step):
            held, unique = engine.lookup_step(self.table_states, inputs,
                                              seed, step)
        loss, preds, aux, gu = self._dense_step(inputs, batch_t, unique, step)
        with span("step.apply", step):
            engine.apply_step(self.table_states, inputs, held, gu, step,
                              seed=seed)
        return loss, preds, aux

    def _step_async(self, inputs, batch_t, step: int, pending):
        """One step of the 1-step-stale schedule:

          1. gather this step's rows (K1): STALE, the previous step's
             write-back has not landed
          2. land the previous step's pending write-back (K2; skipped at
             the first step of a block, which has none)
          3. forward/backward on the stale rows; clip; dense update
          4. gather the rows again (K1): fresh, with the previous update
          5. optimize the FRESH rows, so that no update is lost; DC
             segments receive the stale rows; defer the write-back

        K1's output is a copy, so nothing aliases the pool that K2 writes
        in place between 1 and 2. On one stream the write-back overlaps
        nothing; the order is kept for the numerics. Returns (loss, preds,
        aux, pending = (rows, new packed rows) by table)."""
        engine, seed = self.engine, self.config.seed
        with span("step.lookup", step):
            prows_stale, unique_stale = engine.fused_lookup(
                self.table_states, inputs, seed, step)
        if pending is not None:
            with span("step.apply", step), torch.no_grad():
                engine.scatter_rows(self.table_states, *pending, step,
                                    seed=seed)
        loss, preds, aux, gu = self._dense_step(inputs, batch_t,
                                                unique_stale, step)
        with span("step.apply", step), torch.no_grad():
            prows_latest, _ = engine.fused_lookup(self.table_states, inputs,
                                                  seed, step)
            new_p = engine.optimize_rows(inputs, prows_latest, gu, step,
                                         prows_stale=prows_stale)
        rows = {t: inputs[t]["rows"] for t in new_p}
        return loss, preds, aux, (rows, new_p)

    def train_step(self, fid_batch: Dict[str, np.ndarray],
                   batch: Dict[str, np.ndarray],
                   ts: Optional[int] = None) -> Dict:
        """Run one training step. fid_batch: {feature: int64 [B, L] pad -1};
        batch: dense-side float32/int32 arrays incl. "label". Returns
        {"loss", "preds", "stats", "aux"} with loss/preds on the device."""
        ts = int(time.time()) if ts is None else ts
        with span("train.stage", self.step):
            wires, stats, layout, revives, _ = self._pack_block(
                [(fid_batch, batch)], ts)
            revive = self._upload_revive(revives[0])
        with span("train.step", self.step):
            loss, preds, aux, _ = self._step(wires[0], layout, revive,
                                             self.step)
        self.step += 1
        return {"loss": loss, "preds": preds, "stats": stats[0], "aux": aux}

    def _step(self, wire, layout, revive, step: int, stale: bool = False,
              pending=None):
        """The body of every training step, inside its "train.step" span:
        decode the step's wire (the step number comes from the host, which
        knows it), attach its uploaded revived rows, then the synchronous
        step or, `stale`, the 1-step-stale one. Returns (loss, preds, aux,
        pending write-back: None for a synchronous step)."""
        with span("step.decode", step):
            inputs, batch_t = self._decode(wire, layout)
            self._attach_revive(inputs, revive)
        if stale:
            return self._step_async(inputs, batch_t, step, pending)
        return (*self._step_core(inputs, batch_t, step), None)

    def stage_block(self, pairs, ts: Optional[int] = None) -> Dict:
        """Pack the NEXT block and start its host-to-device upload now, so
        that both overlap the device work of the block dispatched just
        before (on the fused wire: step 0 here, steps 1..K-1 on the stage
        worker while the block dispatches). The staged block bakes in step
        numbers and admissions: it MUST be the next thing dispatched
        (train_step_block checks). Until then only the trainer's own packs
        wait for the worker: touch the host stores in no other way in
        between."""
        ts = int(time.time()) if ts is None else ts
        with span("train.stage", self.step):
            return self._stage(pairs, ts)

    def _stage(self, pairs, ts: int) -> Dict:
        """stage_block's body, inside its "train.stage" span. A block of
        two or more steps whose pack `_stage_overlaps` leaves its steps
        1..K-1 to the stage worker ("prepares"); the dispatch takes each
        of their wires just before its step."""
        wires, stats, layout, revives, prepares = self._pack_block(
            pairs, ts, overlap=len(pairs) > 1 and self._stage_overlaps())
        return {"wires": wires, "stats": stats, "base_step": self.step,
                "K": len(pairs), "layout": layout, "prepares": prepares,
                "revives": [self._upload_revive(r) for r in revives]}

    def train_step_block(self, pairs, ts: Optional[int] = None,
                         staged: Optional[Dict] = None) -> Dict:
        """Run len(pairs) training steps from ONE uploaded buffer, with no
        host-device synchronisation between them. pairs: list of
        (fid_batch, batch); staged: the result of stage_block(pairs), which
        skips the pack and uses the wires already on their way. With
        EngineConfig.async_optimize the steps follow the 1-step-stale
        schedule (_step_async) and the last step's write-back lands at the
        end of the block, keyed with the step that would have landed it
        inside the loop (base step + K): unique to the block, where the
        JAX package keys every block's with step 0 (fault R9 there).

        Returns {"loss": [K], "preds": [K, B] (a dict of them for a task
        whose predictions are a dict), "stats": list of K,
        "aux": {name: [K, ...]}} with the tensors on the device."""
        K = len(pairs)
        try:
            if staged is not None and (staged["base_step"] != self.step
                                       or staged["K"] != K):
                raise ValueError(
                    f"the staged block (steps {staged['base_step']}.."
                    f"{staged['base_step'] + staged['K'] - 1}) is not the "
                    f"next dispatch ({K} steps from {self.step}): "
                    f"stage_block must be followed by its own dispatch")
            with span("train.dispatch", self.step):
                return self._dispatch_block(pairs, ts, staged)
        finally:
            # returned or raised, the stage worker holds no block after
            self._join_prepares()

    def _dispatch_block(self, pairs, ts, staged) -> Dict:
        """train_step_block's body, inside its "train.dispatch" span."""
        K, base = len(pairs), self.step
        if staged is None:
            ts = int(time.time()) if ts is None else ts
            with span("train.stage", base):
                staged = self._stage(pairs, ts)
        wires, stats, layout, revives, prepares = (
            staged["wires"], staged["stats"], staged["layout"],
            staged["revives"], staged["prepares"])
        # the 1-step-stale schedule runs on packed rows (as in the JAX
        # package); a structure-of-arrays block steps synchronously
        stale = self.config.engine.async_optimize and self.engine.packed
        pending = None
        losses, preds, auxes = [], [], []
        for i in range(K):
            with span("train.step", base + i):
                if prepares is not None and i:
                    stats[i], revive = prepares.take(i)
                    revives[i] = self._upload_revive(revive)
                loss, p, aux, pending = self._step(
                    wires[i], layout, revives[i], base + i, stale, pending)
            losses.append(loss)
            preds.append(p)
            auxes.append(aux)
        if pending is not None:
            # the last step's deferred write-back
            with span("step.apply", base + K - 1), torch.no_grad():
                self.engine.scatter_rows(self.table_states, *pending,
                                         base + K, seed=self.config.seed)
        self.step += K
        if isinstance(preds[0], dict):
            preds = {k: torch.stack([p[k] for p in preds]) for k in preds[0]}
        else:
            preds = torch.stack(preds)
        return {"loss": torch.stack(losses), "preds": preds,
                "stats": stats,
                "aux": {k: torch.stack([a[k] for a in auxes])
                        for k in auxes[0]}}

    def evict_expired(self, expire_before: int) -> Dict[str, np.ndarray]:
        """Expiry: evict ids not updated since `expire_before` from the
        host stores of every table with a ttl, and zero their rows on the
        device (one K2 a table), so that no stale state survives into a
        recycled row. Returns the freed rows {table: int64 [n]}."""
        freed = self.engine.evict_expired(expire_before)
        self.engine.zero_rows(self.table_states, freed)
        return freed

    @torch.no_grad()
    def spill_expired(self, expire_before: int) -> Dict[str, int]:
        """Two-tier expiry (EngineConfig(tiered=True)): per table, evict
        the expired ids from the host store of the trainer's own shard,
        gather just their rows with ONE K1 launch (`pad_rows`), keep the
        first `state_width` columns (params and optimizer slots, as f32)
        in the shard's host archive, then zero the rows
        (engine.zero_rows). Only the
        expired rows cross to the host; the JAX package reads back the
        whole pool and takes the same values. Returns the rows spilled by
        table."""
        if not self.config.engine.tiered:
            raise ValueError("spill_expired requires EngineConfig(tiered=True)")
        spilled, freed = {}, {}
        for tname in self.engine.tables:
            rows, fids = self.engine.store_of(tname).evict_expired(
                expire_before, return_fids=True)
            freed[tname] = rows.astype(np.int64)
            spilled[tname] = self._spill(tname, rows, fids, expire_before)
        self.engine.zero_rows(self.table_states, freed)
        return spilled

    def _spill(self, tname: str, rows: np.ndarray, fids: np.ndarray,
               ts: int) -> int:
        """Gather `rows` of the trainer's own pool with ONE K1 launch
        (`pad_rows`) and archive their first `state_width` columns under
        `fids` in its own shard's archive. Returns the rows archived."""
        if not len(rows):
            return 0
        values = table_lib.full_rows(
            self.engine.tables[tname], self.table_states[tname],
            torch.from_numpy(pad_rows(rows)).to(self.device))
        return self.engine.archive_of(tname).spill(
            fids, values[:len(rows)].cpu().numpy(), ts=ts)

    def _drain_metrics(self):
        """Read back and reset the on-device metric accumulator (the only
        metric readback; at log prints and the end of train)."""
        if self._dev_metrics is None:
            return
        m = {k: v.cpu().numpy() for k, v in self._dev_metrics.items()}
        self.auc.update_histograms(m["pos"], m["neg"])
        w = float(m["loss_weight"])
        if w > 0:
            self.loss_mean.update(float(m["loss_sum"]) / w, weight=w)
        self._dev_metrics = None

    @torch.no_grad()
    def _eval_forward(self, fid_batch, batch):
        """Forward only, through the wire path (K1 gather, no init, no
        write-back). Returns (module outputs, batch tensors)."""
        inputs, batch_t, _ = self._upload(fid_batch, batch, 0)
        engine = self.engine
        unique = self._exchange(engine.lookup_unique(self.table_states,
                                                     inputs), inputs)
        pooled = engine.pool_features(engine.retrieve_unique(unique,
                                                             self.step),
                                      inputs)
        return (self._forward(pooled, batch_t, self.step, training=False),
                batch_t)

    def predict(self, fid_batch: Dict[str, np.ndarray],
                batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """The eval predictions [B] of one batch, on the device: what a
        serving replica loaded from an export of this state must answer."""
        out, _ = self._eval_forward(fid_batch, batch)
        return self._gather(self.task.predictions(out))

    @torch.no_grad()
    def evaluate(self, data: Iterator, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Forward only. data yields (fid_batch, batch). Returns
        {"auc":…, "loss":…}."""
        task = self.task
        auc, loss_mean = StreamingAUC(), StreamingMean()
        for i, (fid_batch, batch) in enumerate(data):
            if max_steps is not None and i >= max_steps:
                break
            out, batch_t = self._eval_forward(fid_batch, batch)
            loss, _ = task.loss(out, batch_t)
            auc.update(self._gather(task.predictions(out)).cpu().numpy(),
                       batch["label"])
            loss_mean.update(float(self._mean(loss)))
        return {"auc": auc.result(), "loss": loss_mean.result()}

    def _block_capable(self) -> bool:
        """Whether train() may run blocks at all: as in the JAX package,
        only on the fused wire (`engine.fuse_wire`): not for a tiered
        engine, whose steps revive rows at their own prepare, nor on the
        multi-array path. The sharded trainers override this."""
        return self.engine.fuse_wire

    def _stage_overlaps(self) -> bool:
        """Whether a block of two or more steps packs its steps 1..K-1 on
        the stage worker while the steps before them dispatch: on the fused
        wire, whose pack is this process's own host work (one native call
        a step, which releases the interpreter lock). The sharded trainers,
        whose packs run per-shard prepares and collectives, return False:
        they pack on the calling thread."""
        return self.engine.fuse_wire

    def _graph_capable(self) -> bool:
        """Whether the training step's pooling and tower may run as
        captured CUDA graphs (training/graphs.py): on the card, with no
        drawing layers (their generator is reseeded from the host each
        step), no model state (the capture's warm-up would move batch
        statistics) and no retriever (it takes the host's step). The
        sharded trainers override this."""
        return (self.device.type == "cuda"
                and self._draws is None
                and next(self.module.buffers(), None) is None
                and all(seg.retriever is None
                        for spec in self.engine.tables.values()
                        for seg in spec.segments))

    def _log(self, t0: float, examples: int) -> None:
        self._drain_metrics()
        dt = time.time() - t0
        print(f"step {self.step}: loss={self.loss_mean.result():.4f} "
              f"auc={self.auc.result():.4f} "
              f"ex/s={examples / max(dt, 1e-9):.0f}")

    def _result(self, t0: float, examples: int) -> Dict[str, float]:
        self._drain_metrics()
        return {"auc": self.auc.result(), "loss": self.loss_mean.result(),
                "examples_per_sec": examples / max(time.time() - t0, 1e-9)}

    def train(self, data: Iterator, steps: Optional[int] = None,
              hooks=()) -> Dict[str, float]:
        """Run the training loop over `data` (yields (fid_batch, batch)).
        Each hook is called as h(trainer, out) after every step; a hook
        that raises StopIteration asks for a clean stop.

        With config.steps_per_dispatch = K > 1 on a trainer that
        `_block_capable` admits, steps run in blocks of K and hooks fire
        once per block; otherwise in groups of one, each a `train_step`.
        Exactly `steps` batches are read from `data`."""
        K = max(1, self.config.steps_per_dispatch)
        return self._train_blocked(data, steps, hooks,
                                   K if K > 1 and self._block_capable() else 1)

    def _train_blocked(self, data: Iterator, steps: Optional[int],
                       hooks, K: int) -> Dict[str, float]:
        """The training loop. Batches come in groups of K, so groups end at
        steps K, 2K, ... and at the last step, as in the JAX package; every
        group of more than one batch runs as a block (the short tail too),
        staged (packed and uploading) while the block before it runs; a
        group of one runs as a step. Hooks fire once per group, with the
        group's last output; a group that reaches a multiple of
        `log_every` drains the metrics and prints its line, the stopping
        group too."""
        t0 = time.time()
        examples = 0
        done = 0
        it = iter(data)

        def fetch(want):
            pairs = []
            with span("train.fetch", self.step):
                for _ in range(want):
                    try:
                        pairs.append(next(it))
                    except StopIteration:
                        break
            return pairs

        def stage(pairs):
            # only a group that will be dispatched as a block may be
            # staged: the pack bakes in step numbers and host-store
            # admissions
            return self.stage_block(pairs) if len(pairs) > 1 else None

        pairs = fetch(K if steps is None else min(K, steps))
        staged = stage(pairs)
        while pairs:
            if len(pairs) > 1:
                out = self.train_step_block(pairs, staged=staged)
            else:
                out = self.train_step(*pairs[0])
            staged = None
            done += len(pairs)
            examples += sum(len(next(iter(b.values()))) for _, b in pairs)
            with span("train.hooks", self.step - len(pairs)):
                stop = _call_hooks(hooks, self, out)
            log_now = self.config.log_every and (
                self.step % self.config.log_every < len(pairs))
            if stop or (steps is not None and done >= steps):
                pairs = []
            else:
                pairs = fetch(K if steps is None else min(K, steps - done))
                # lookahead: pack and upload the next block while this one
                # still runs on the device
                staged = stage(pairs)
            if log_now:
                self._log(t0, examples)
        return self._result(t0, examples)


def _detach(preds):
    """A task's predictions or auxiliary losses (a tensor or a dict of
    them), detached."""
    if isinstance(preds, dict):
        return {k: v.detach() for k, v in preds.items()}
    return preds.detach()


def _call_hooks(hooks, trainer, out) -> bool:
    """Call every hook; True if one asked for a clean stop."""
    stop = False
    for h in hooks:
        try:
            h(trainer, out)
        except StopIteration:
            stop = True
    return stop

"""Single-device trainer on the card (the port's `Trainer`).

Per step:

  host:   prepare_wire (C++ dedup + id map + pack) writes the engine wire,
          the batch arrays' raw 4-byte words and the step number into ONE
          pinned int32 buffer, sent to the card with one non_blocking copy
  device: decode -> fused_lookup (K1 gather + new-row init select) ->
          pool -> dense fwd/bwd -> dense Adagrad (optax form) ->
          fused_apply (per-row optimize + K2 scatter)

State is updated in place: the table pools by the K2 scatter, the dense
parameters and accumulators by the optimizer. (The JAX program donates
them to each step instead.) Dense parameters are created at construction
from a CPU generator seeded with `config.seed`, so a trainer on the card
and one on the CPU start from identical weights; every step, the first
included, takes the fused wire path.

Loss and AUC accumulate on the device (metrics.device_metrics_update) and
are read back only by `_drain_metrics`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from monolith_tpu_torch.device import resolve_device
from monolith_tpu_torch.embedding.engine import EmbeddingEngine, EngineConfig
from monolith_tpu_torch.metrics import (StreamingAUC, StreamingMean,
                                        device_metrics_init,
                                        device_metrics_update)
from monolith_tpu_torch.training.task import RecTask

_WIRE_DTYPES = {np.dtype(np.float32).str: torch.float32,
                np.dtype(np.int32).str: torch.int32}


@dataclasses.dataclass
class TrainerConfig:
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    seed: int = 0
    log_every: int = 100


class _PinnedWires:
    """Two pinned host buffers for the per-step wire, used in turn. A
    buffer is refilled only after the copy that last read it has finished
    (its CUDA event), so the host packs step N+1 while step N's copy may
    still be in flight."""

    def __init__(self, words: int, device: torch.device):
        self.device = device
        pin = device.type == "cuda"
        self.bufs = [torch.empty(words, dtype=torch.int32, pin_memory=pin)
                     for _ in range(2)]
        self.events = [None, None]
        self.i = 0

    def host(self) -> np.ndarray:
        """The next buffer to fill, as a numpy view."""
        if self.events[self.i] is not None:
            self.events[self.i].synchronize()
        return self.bufs[self.i].numpy()

    def upload(self) -> torch.Tensor:
        """Send the filled buffer to the device; returns the device copy."""
        buf = self.bufs[self.i]
        if self.device.type == "cuda":
            wire = buf.to(self.device, non_blocking=True)
            self.events[self.i] = torch.cuda.Event()
            self.events[self.i].record()
        else:
            wire = buf.clone()
        self.i ^= 1
        return wire


class Trainer:
    """Owns engine host state, table pools, dense module and optimizer."""

    def __init__(self, task: RecTask, config: TrainerConfig = TrainerConfig(),
                 device=None):
        self.task = task
        self.config = config
        self.device = resolve_device(device)
        self.engine = EmbeddingEngine(task.tables(), task.features(),
                                      config.engine, seed=config.seed,
                                      device=self.device)
        generator = torch.Generator().manual_seed(config.seed)
        self.module = task.build_module(generator=generator).to(self.device)
        self.tx = task.dense_optimizer()
        self.opt_state = self.tx.init(self.module.named_parameters())
        self.table_states = self.engine.create_states()
        self.step = 0
        self.auc = StreamingAUC()
        self.loss_mean = StreamingMean()
        self._dev_metrics = None
        self._wires: Dict[tuple, _PinnedWires] = {}

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
        return (self.engine.wire_words(layout[0][2][0])
                + sum(int(np.prod(s)) for _, _, s in layout) + 1)

    def _pack_full_wire(self, fid_batch, batch, layout, ts, stepno, out):
        """Host side of _decode_full_wire, into the int32 buffer `out`."""
        ew = self.engine.wire_words(layout[0][2][0])
        _, stats = self.engine.prepare_wire(fid_batch, ts=ts, out=out[:ew])
        off = ew
        for k, _, shape in layout:
            n = int(np.prod(shape))
            out[off:off + n] = np.ascontiguousarray(batch[k]).view(np.int32).ravel()
            off += n
        out[off] = stepno
        return stats

    def _upload(self, fid_batch, batch, ts, stepno):
        """Pack one step's wire into a pinned buffer and send it to the
        device; returns (decoded engine inputs, batch tensors, stats)."""
        layout = self._batch_layout(batch)
        if layout not in self._wires:
            self._wires[layout] = _PinnedWires(self._full_wire_words(layout),
                                               self.device)
        staging = self._wires[layout]
        stats = self._pack_full_wire(fid_batch, batch, layout, ts, stepno,
                                     staging.host())
        wire = staging.upload()
        inputs, batch_t, _ = self._decode_full_wire(
            self.engine, wire, layout,
            self.engine.wire_words(layout[0][2][0]))
        return inputs, batch_t, stats

    @staticmethod
    def _decode_full_wire(engine, wire, layout, engine_words):
        """Device-side split of the single-transfer step input: engine wire
        region, then each batch array's raw 4-byte words (reinterpreted),
        then the step number as the final word."""
        bsz = layout[0][2][0]
        inputs = engine.decode_wire(wire[:engine_words], bsz)
        off = engine_words
        batch = {}
        for k, dstr, shape in layout:
            n = int(np.prod(shape))
            chunk = wire[off:off + n]
            off += n
            batch[k] = chunk.view(_WIRE_DTYPES[dstr]).reshape(shape)
        stepno = wire[off]
        return inputs, batch, stepno

    # ------------------------------------------------------------------

    def _metrics_update(self, loss, preds, batch_t):
        if self._dev_metrics is None:
            self._dev_metrics = device_metrics_init(self.auc.num_thresholds,
                                                    self.device)
        device_metrics_update(self._dev_metrics, loss, preds,
                              batch_t["label"])

    def train_step(self, fid_batch: Dict[str, np.ndarray],
                   batch: Dict[str, np.ndarray],
                   ts: Optional[int] = None) -> Dict:
        """Run one training step. fid_batch: {feature: int64 [B, L] pad -1};
        batch: dense-side float32/int32 arrays incl. "label". Returns
        {"loss", "preds", "stats", "aux"} with loss/preds on the device."""
        ts = int(time.time()) if ts is None else ts
        engine, task, step = self.engine, self.task, self.step
        inputs, batch_t, stats = self._upload(fid_batch, batch, ts, step)
        prows, unique = engine.fused_lookup(self.table_states, inputs,
                                            self.config.seed, step)
        # differentiate wrt the gathered unique rows, not the pool
        leaves = {t: u.detach().requires_grad_() for t, u in unique.items()}
        pooled = engine.pool_features(engine.retrieve_unique(leaves, step),
                                      inputs)
        out = self.module(pooled, batch_t)
        loss, aux = task.loss(out, batch_t)
        named = list(self.module.named_parameters())
        grads = torch.autograd.grad(
            loss, [p for _, p in named] + list(leaves.values()))
        gp = {name: g for (name, _), g in zip(named, grads)}
        gu = dict(zip(leaves, grads[len(named):]))
        self.tx.update_(named, gp, self.opt_state)
        with torch.no_grad():
            engine.fused_apply(self.table_states, inputs, prows, gu, step)
            preds = task.predictions(out).detach()
        loss = loss.detach()
        self._metrics_update(loss, preds, batch_t)
        self.step += 1
        return {"loss": loss, "preds": preds, "stats": stats, "aux": aux}

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
    def evaluate(self, data: Iterator, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Forward only. data yields (fid_batch, batch). Returns
        {"auc":…, "loss":…}."""
        engine, task = self.engine, self.task
        auc, loss_mean = StreamingAUC(), StreamingMean()
        for i, (fid_batch, batch) in enumerate(data):
            if max_steps is not None and i >= max_steps:
                break
            inputs, batch_t, _ = self._upload(fid_batch, batch, 0, self.step)
            pooled, _ = engine.embed(self.table_states, inputs, step=self.step)
            out = self.module(pooled, batch_t)
            loss, _ = task.loss(out, batch_t)
            auc.update(task.predictions(out).cpu().numpy(), batch["label"])
            loss_mean.update(float(loss))
        return {"auc": auc.result(), "loss": loss_mean.result()}

    def train(self, data: Iterator, steps: Optional[int] = None
              ) -> Dict[str, float]:
        """Run the training loop over `data` (yields (fid_batch, batch)),
        one step per dispatch (block dispatch is not ported yet)."""
        t0 = time.time()
        examples = 0
        for i, (fid_batch, batch) in enumerate(data):
            if steps is not None and i >= steps:
                break
            self.train_step(fid_batch, batch)
            examples += len(next(iter(batch.values())))
            if self.config.log_every and (self.step % self.config.log_every == 0):
                self._drain_metrics()
                dt = time.time() - t0
                print(f"step {self.step}: loss={self.loss_mean.result():.4f} "
                      f"auc={self.auc.result():.4f} "
                      f"ex/s={examples / max(dt, 1e-9):.0f}")
        self._drain_metrics()
        return {"auc": self.auc.result(), "loss": self.loss_mean.result(),
                "examples_per_sec": examples / max(time.time() - t0, 1e-9)}

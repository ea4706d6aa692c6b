"""Two-tier embedding storage: the device pool holds the working set, a
host-RAM archive holds the full state of rows that expired.

- spill: `Trainer.spill_expired` evicts expired ids from the host store,
  gathers just their rows from the device pool (K1 on the card) and stores
  each row's full state (params and optimizer slots) here, before the
  device rows are zeroed and recycled;
- revive: when a spilled id is admitted again, `EmbeddingEngine.
  prepare_batch` takes its archived state out of the archive and ships it
  beside the step's wire; `fused_lookup` lays it over the gathered row (a
  structure-of-arrays engine's `admit_rows` writes it with
  `table.restore_packed_rows`), so training resumes where the id left
  off.

The archive reuses the collisionless `HostStore` as its fid -> archive row
map, plus flat numpy value arrays, with oldest-first recycling when it is
full. A copy of the JAX package's module: the same sequence of calls gives
the same archive contents and counters.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from monolith_tpu_torch.embedding.host_store import HostStore
from monolith_tpu_torch.embedding.spec import TableSpec


def state_width(spec: TableSpec) -> int:
    """Total row width: params dim + all optimizer slot widths."""
    w = spec.dim
    for seg in spec.segments:
        for _, (k, _) in sorted(seg.optimizer.slot_spec(seg.dim).items()):
            w += k
    return w


def pack_rows(spec: TableSpec, state, rows: np.ndarray) -> np.ndarray:
    """[len(rows), width] full state of `rows` of a state held on the host
    (any f32 arrays). Of a packed state ({"data": [cap, P]}) a direct
    slice: the archive's row format is the pool's, its first `state_width`
    columns; of a structure-of-arrays state the params, then each
    segment's slots in sorted-name order, concatenated."""
    if "data" in state:
        return np.asarray(state["data"],
                          np.float32)[rows][:, :state_width(spec)]
    pieces = [np.asarray(state["params"], np.float32)[rows]]
    for seg_slots in state["slots"]:
        for name in sorted(seg_slots):
            pieces.append(np.asarray(seg_slots[name], np.float32)[rows])
    return np.concatenate(pieces, axis=1)


def split_row_values(spec: TableSpec, values: np.ndarray
                     ) -> Tuple[np.ndarray, list]:
    """Inverse of pack_rows: (params [n, D], per-segment {name: [n, k]})."""
    off = spec.dim
    params = values[:, :off]
    slots = []
    for seg in spec.segments:
        d = {}
        for name, (k, _) in sorted(seg.optimizer.slot_spec(seg.dim).items()):
            d[name] = values[:, off:off + k]
            off += k
        slots.append(d)
    return params, slots


class RowArchive:
    """Host-RAM store of full row state for one table."""

    def __init__(self, spec: TableSpec, capacity: int, seed: int = 0):
        self.spec = spec
        self.capacity = capacity
        self.width = state_width(spec)
        self.map = HostStore(row_capacity=capacity, seed=seed)
        self.values = np.zeros((capacity, self.width), dtype=np.float32)
        self.tss = np.zeros(capacity, dtype=np.uint32)
        self.spilled = 0
        self.revived = 0
        self.dropped = 0

    def spill(self, fids: np.ndarray, values: np.ndarray, ts: int) -> int:
        """Store rows; when full, recycle the oldest archived rows. Returns
        the number stored."""
        fids = np.asarray(fids, np.int64)
        rows, _, _ = self.map.assign(fids, ts=ts)
        full = rows < 0
        if full.any():
            need = int(full.sum())
            a_fids, a_rows, a_tss, _ = self.map.save()
            order = np.argsort(a_tss)[:need]
            if len(order):
                self.map.restore(np.delete(a_fids, order),
                                 np.delete(a_rows, order),
                                 np.delete(a_tss, order), None)
                rows2, _, _ = self.map.assign(fids[full], ts=ts)
                rows[full] = rows2
            self.dropped += int((rows < 0).sum())
        ok = rows >= 0
        self.values[rows[ok]] = values[ok]
        self.tss[rows[ok]] = ts
        self.spilled += int(ok.sum())
        return int(ok.sum())

    def revive(self, fids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Look up archived rows of `fids`; returns (found mask, values
        [n, width]). Found entries leave the archive: their state lives in
        the device pool again."""
        fids = np.asarray(fids, np.int64)
        rows = self.map.lookup(fids)
        ok = rows >= 0
        out = np.zeros((len(fids), self.width), dtype=np.float32)
        out[ok] = self.values[rows[ok]]
        if ok.any():
            a_fids, a_rows, a_tss, _ = self.map.save()
            keep = ~np.isin(a_fids, fids[ok])
            self.map.restore(a_fids[keep], a_rows[keep], a_tss[keep], None)
        self.revived += int(ok.sum())
        return ok, out

    def size(self) -> int:
        return self.map.size()

    def save(self, path: str) -> None:
        """One .npz with the JAX package's keys: fids, rows, tss, values."""
        fids, rows, tss, _ = self.map.save()
        np.savez(path, fids=fids, rows=rows, tss=tss,
                 values=self.values[rows] if len(rows) else
                 np.zeros((0, self.width), np.float32))

    def restore(self, path: str) -> None:
        z = np.load(path)
        fids = z["fids"]
        self.map = HostStore(row_capacity=self.capacity)
        if len(fids):
            rows, _, _ = self.map.assign(fids)
            self.values[rows] = z["values"]
            self.tss[rows] = z["tss"]

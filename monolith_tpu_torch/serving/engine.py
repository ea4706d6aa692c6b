"""Serving-side inference engine.

A `ServingModel` holds ONE merged read-only id -> row store per table (the
shards of a sharded trainer's export are merged at load, which gives
resharding for free), a device row pool with headroom for online updates,
and the dense module. Realtime parameter sync lands through `apply_delta`.

Pools are f32 `[cap, spec.dim]` tensors on the device, structure-of-arrays
states `{"params": pool, "slots": []}` to `table.lookup` (a bf16 training
pool was exported as f32). Their rows are `spec.dim` floats wide (68 bytes
for DeepFM), no whole number of 16-byte vectors, so the lookup is plain
PyTorch (`index_select` on clamped rows and a mask) as it is plain XLA in
the JAX package: serving launches none of the port's kernels.

The forward is the task's `nn.Module` in eval mode under
`torch.inference_mode()`; there is nothing to trace or compile. The module
owns its parameters from construction, so `dense.msgpack` (and, for a
module with non-parameter state, `model_state.msgpack`: BatchNorm's running
statistics) is loaded into it when the model is constructed (the JAX
package defers that to the first predict, when it can build a template).

Concurrency. `predict` does its host prepare (dedup, id -> row lookup) and
takes references to the pools and the module under the version lock, then
runs the forward outside it. `reload_export` and `reload_dense` build new
tensors off to the side and swap whole references under the lock: a predict
in flight keeps the version it started with, and never pairs one version's
row indices with another's pools. On the card `apply_delta` writes pushed
rows into the pool IN PLACE under the lock (the JAX package makes a new pool
array). Device work of all threads runs in order on one stream, so a forward
already enqueued reads the rows from before the push; a predict that holds
its row indices but has not yet enqueued its gather reads the pushed rows.
That is harmless: a serving store never recycles a row, so an index always
names the same id, and the predict sees that id's older or newer value,
never a part of a push. On a CPU device there is no stream to order a
thread's reads with another's writes, so there `apply_delta` writes a copy
of the pool and swaps it in under the lock, as the JAX package does: a push
costs a copy of the pool, and a predict in flight keeps the pool it took.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from monolith_tpu_torch import convert, serialization
from monolith_tpu_torch.device import resolve_device
from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.embedding.host_store import (Batcher, HostStore,
                                                     shard_of_batch)
from monolith_tpu_torch.feature import combine
from monolith_tpu_torch.training.task import RecTask


def load_module(task: RecTask, dense_bytes: bytes,
                device: torch.device,
                model_state: Optional[Dict] = None) -> torch.nn.Module:
    """A new task module on `device` in eval mode with `dense_bytes` (a
    dense.msgpack) as its parameters and `model_state` (a
    `convert.model_state_tree`), if given, as its buffers; names and
    shapes must match."""
    module = task.build_module()
    params = dict(module.named_parameters())
    convert.load_dense_tree(params, serialization.from_bytes(
        convert.dense_tree(params), dense_bytes))
    if model_state is not None:
        convert.load_model_state(module, model_state)
    return module.to(device).eval()


def pool_table(buf: torch.Tensor, index: torch.Tensor, features,
               shapes) -> Dict[str, torch.Tensor]:
    """One table's pooled features: `buf` [n, dim] holds the table's
    unique rows of the request, `index` the flat int32 index into it over
    all of `features`' streams in order (-1 for padding, which reads a zero
    row), `shapes` each stream's [B, L]. Each feature is a slice of one
    gather, pooled by its combiner."""
    n, dim = buf.shape
    # row n of the padded buffer is the zero row that -1 reads
    padded = torch.cat([buf, buf.new_zeros((1, dim))])
    emb = padded.index_select(0, torch.where(index < 0, n, index))
    pooled, off = {}, 0
    for f, shape in zip(features, shapes):
        size = int(np.prod(shape))
        e = emb[off:off + size].reshape(*shape, dim)
        valid = index[off:off + size].reshape(shape) >= 0
        pooled[f.name] = combine(e, valid, f.combiner)
        off += size
    return pooled


def batch_tensors(batch: Dict[str, np.ndarray],
                  device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=True) for k, v in batch.items()}


class ServingModel:
    """Loads an export and serves predictions; accepts online row deltas.

    `device=None` means the card and raises without CUDA; pass
    `device="cpu"` to serve from the host.

    Row-sharded serving: pass `num_row_shards` > 1 and a `shard_index` to
    load only the rows whose `shard_of(fid, num_row_shards) == shard_index`;
    the replica then acts as one embedding shard behind `lookup_rows`. The
    training shard count is irrelevant (files are re-routed at load)."""

    def __init__(self, task: RecTask, export_path: str,
                 headroom: float = 0.25, unique_cap: int = 8192,
                 shard_index: int = 0, num_row_shards: int = 1,
                 device=None):
        self.task = task
        self.device = resolve_device(device)
        self.tables = {t.name: t for t in task.tables()}
        self.features = {f.name: f for f in task.features()}
        self.table_features: Dict[str, List[str]] = {}
        for fname, f in self.features.items():
            self.table_features.setdefault(f.table, []).append(fname)
        self.unique_cap = unique_cap
        self.shard_index = shard_index
        self.num_row_shards = num_row_shards
        self.headroom = headroom
        self._lock = threading.Lock()

        with open(os.path.join(export_path, "meta.json")) as f:
            self.meta = json.load(f)
        self.step = self.meta["step"]
        with open(os.path.join(export_path, "dense.msgpack"), "rb") as f:
            self.module = load_module(task, f.read(), self.device)
        serialization.load_model_state(export_path, self.module)

        self.stores: Dict[str, HostStore] = {}
        self.pools: Dict[str, torch.Tensor] = {}
        self.capacity: Dict[str, int] = {}
        for tname, tmeta in self.meta["tables"].items():
            spec = self.tables[tname]
            all_fids, all_vals = [], []
            for s in range(tmeta["shards"]):
                z = np.load(os.path.join(export_path, "tables",
                                         f"{tname}-s{s}.npz"))
                fids = z["fids"]
                segs = []
                for i, seg in enumerate(spec.segments):
                    blob = {k.split(":", 1)[1]: z[k] for k in z.files
                            if k.startswith(f"seg{i}:")}
                    segs.append(seg.compressor.decompress(blob) if len(fids)
                                else np.zeros((0, seg.dim), np.float32))
                vals = (np.concatenate(segs, axis=1) if segs
                        else np.zeros((len(fids), spec.dim), np.float32))
                if self.num_row_shards > 1 and len(fids):
                    keep = (shard_of_batch(fids, self.num_row_shards)
                            == self.shard_index)
                    fids, vals = fids[keep], vals[keep]
                all_fids.append(fids)
                all_vals.append(vals)
            cap = int(sum(len(f) for f in all_fids) * (1 + headroom)) + 1024
            self.capacity[tname] = cap
            store = HostStore(row_capacity=cap)
            pool = np.zeros((cap, spec.dim), dtype=np.float32)
            for fids, vals in zip(all_fids, all_vals):
                if len(fids):
                    rows, _, _ = store.assign(fids)
                    pool[rows] = vals
            self.stores[tname] = store
            self.pools[tname] = torch.from_numpy(pool).to(self.device)
        self._batchers = {t: Batcher(expected_unique=unique_cap)
                          for t in self.tables}

    # ------------------------------------------------------------------

    def _prepare(self, fid_batch) -> Dict:
        """Host half of predict (caller holds the lock): per table the
        unique rows [unique_cap] int32 (-1 pad / unknown id) and ONE flat
        int32 index over all of the table's feature streams, in
        `table_features` order (-1 for padding)."""
        inputs = {}
        for tname, fnames in self.table_features.items():
            streams = [np.ascontiguousarray(fid_batch[f], dtype=np.int64)
                       for f in fnames]
            flat = np.concatenate([s.ravel() for s in streams])
            unique, index, counts, _ = self._batchers[tname].dedup(
                flat, num_shards=1, shard_cap=self.unique_cap)
            rows = np.full(self.unique_cap, -1, dtype=np.int32)
            c = int(counts[0])
            if c:
                rows[:c] = self.stores[tname].lookup(unique[0, :c])
            inputs[tname] = {"rows": rows, "index": index,
                             "shapes": [s.shape for s in streams]}
        return inputs

    def _forward(self, module, pools, inputs, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device half of predict: per table one lookup of the unique rows
        and one gather over the flat index; per feature a slice and its
        combiner; the module. Returns (the task's predictions, the
        module's logits), as the JAX package's does."""
        dev = self.device
        pooled = {}
        for tname, tin in inputs.items():
            spec = self.tables[tname]
            rows = torch.from_numpy(tin["rows"]).to(dev, non_blocking=True)
            buf = table_lib.lookup(
                spec, {"params": pools[tname], "slots": []}, rows)
            pooled.update(pool_table(
                buf, torch.from_numpy(tin["index"]).to(dev, non_blocking=True),
                [self.features[f] for f in self.table_features[tname]],
                tin["shapes"]))
        out = module(pooled, batch_tensors(batch, dev))
        return self.task.predictions(out), out["logits"]

    def predict(self, fid_batch: Dict[str, np.ndarray],
                batch: Optional[Dict[str, np.ndarray]] = None,
                timing: Optional[Dict[str, float]] = None) -> np.ndarray:
        """Serve predictions for a batch of sparse features; returns numpy
        (so it waits for the device).

        The host prepare and the references to pools and module are taken
        under the version lock, so a concurrent reload_export cannot pair
        old-store row indices with a new version's pools; the forward runs
        outside it.

        `timing`: a dict to fill with this predict's parts on the host
        clock, `prepare_ms` (dedup and id lookup under the lock),
        `device_ms` (upload and forward, waited for: asking for the times
        adds that wait) and `readback_ms`."""
        batch = batch or {}
        t0 = time.perf_counter()
        with self._lock:
            inputs = self._prepare(fid_batch)
            pools, module = dict(self.pools), self.module
        t1 = time.perf_counter()
        with torch.inference_mode():
            preds, _ = self._forward(module, pools, inputs, batch)
        if timing is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        out = preds.cpu().numpy()
        if timing is not None:
            timing.update(prepare_ms=(t1 - t0) * 1e3,
                          device_ms=(t2 - t1) * 1e3,
                          readback_ms=(time.perf_counter() - t2) * 1e3)
        return out

    def lookup_rows(self, table: str, fids: np.ndarray) -> np.ndarray:
        """Embedding-shard role: raw id -> value lookup (missing ids read
        zeros)."""
        fids = np.asarray(fids, np.int64)
        with self._lock:  # store and pool of one version
            rows = self.stores[table].lookup(fids)
            pool = self.pools[table]
        with torch.inference_mode():
            out = table_lib.lookup(
                self.tables[table], {"params": pool, "slots": []},
                torch.from_numpy(rows).to(self.device))
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # realtime updates (parameter sync receive path)

    def apply_delta(self, table: str, fids: np.ndarray,
                    values: np.ndarray) -> int:
        """Assign pushed rows (new ids admitted unconditionally): in place
        on the card, into a copy that is swapped in on a CPU device (see
        the module docstring for what a concurrent predict may see).
        Returns the number of rows applied (ids beyond the pool's capacity
        are dropped)."""
        spec = self.tables[table]
        values = np.ascontiguousarray(values, np.float32)
        if values.ndim != 2 or values.shape[1] != spec.dim:
            raise ValueError(f"table {table}: pushed values "
                             f"{values.shape} are not [n, {spec.dim}]")
        with self._lock, torch.inference_mode():  # assign + pool write
            rows, _, _ = self.stores[table].assign(np.asarray(fids, np.int64))
            ok = rows >= 0
            pool = self.pools[table]
            if self.device.type == "cpu":
                pool = pool.clone()
            table_lib.assign_rows(
                spec, {"params": pool, "slots": []},
                torch.from_numpy(rows[ok]).to(self.device),
                torch.from_numpy(values[ok]).to(self.device))
            self.pools[table] = pool
        return int(ok.sum())

    def reload_dense(self, dense_bytes: bytes) -> None:
        """Hot-swap the dense params (the dense-only fast checkpoint
        path): a new module is built with the serving one's non-parameter
        state and swapped in whole."""
        module = load_module(self.task, dense_bytes, self.device,
                             convert.model_state_tree(self.module))
        with self._lock:
            self.module = module

    def reload_export(self, export_path: str) -> int:
        """Hot-swap the WHOLE model to a new export version, atomically:
        the new version is built off to the side (memory briefly holds
        both), then stores, pools and module swap under the version lock.
        The old tensors stay alive for predicts in flight. Returns the new
        version's step."""
        fresh = ServingModel(self.task, export_path, headroom=self.headroom,
                             unique_cap=self.unique_cap,
                             shard_index=self.shard_index,
                             num_row_shards=self.num_row_shards,
                             device=self.device)
        with self._lock:
            self.meta, self.step = fresh.meta, fresh.step
            self.stores, self.pools = fresh.stores, fresh.pools
            self.capacity = fresh.capacity
            self._batchers = fresh._batchers
            self.module = fresh.module
        return self.step

    def table_sizes(self) -> Dict[str, int]:
        return {t: s.size() for t, s in self.stores.items()}

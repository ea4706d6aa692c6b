"""Entry router for row-sharded serving.

The rebuild of the reference's distributed serving entry graph (an
"entry" graph over per-PS "ps_i" sub-graphs reached through remote
predict): N serving replicas each hold one row shard of every table
(`ServingModel(shard_index=s, num_row_shards=N)`); the router holds only
the dense tower. It dedups each request's ids grouped by owning shard
(`shard_of(fid, N)`, the hash training and the serving loader use), fans
the unique ids out to their shards on a thread pool, merges the returned
rows into one `[N * unique_cap, dim]` f32 buffer a table, uploads it once,
and pools and runs the module on the device. Every embedding value and the
per-example pooling order are those of a single-replica `ServingModel`, and
the pooling is the same code (`engine.pool_table`), so the predictions are
the single model's bit for bit.

The JAX package's router jits its own forward and builds its parameters at
the first predict. Here the task's module is built and `dense.msgpack`
(and `model_state.msgpack`, for a module with BatchNorm statistics) loaded
into it at construction, as `ServingModel` does.
"""

from __future__ import annotations

import json
import os
from concurrent import futures
from typing import Dict, List, Optional

import numpy as np
import torch

from monolith_tpu_torch import serialization
from monolith_tpu_torch.device import resolve_device
from monolith_tpu_torch.embedding.host_store import Batcher
from monolith_tpu_torch.serving.engine import (batch_tensors, load_module,
                                               pool_table)
from monolith_tpu_torch.training.task import RecTask


class ShardedServingRouter:
    """Routes predict requests over row-shard replicas.

    `shards`: {shard_index: replica} where a replica is anything with
    `lookup(table, fids)` (a ServingClient) or `lookup_rows(table, fids)`
    (an in-process ServingModel). Must cover shards 0..num_row_shards-1.
    `unique_cap` is the per-request limit of unique ids a shard; a request
    beyond it is refused. `device=None` means the card. `predict` may be
    called from several threads (the native dedup holds a lock a call).
    """

    def __init__(self, task: RecTask, export_path: str,
                 shards: Dict[int, object],
                 num_row_shards: Optional[int] = None,
                 unique_cap: int = 8192, device=None):
        self.task = task
        self.device = resolve_device(device)
        self.tables = {t.name: t for t in task.tables()}
        self.features = {f.name: f for f in task.features()}
        self.table_features: Dict[str, List[str]] = {}
        for fname, f in self.features.items():
            self.table_features.setdefault(f.table, []).append(fname)
        self.unique_cap = unique_cap
        self.num_row_shards = num_row_shards or len(shards)
        self._lookups = {}
        for s, rep in shards.items():
            fn = getattr(rep, "lookup", None) or getattr(rep, "lookup_rows")
            self._lookups[int(s)] = fn
        for s in range(self.num_row_shards):
            if s not in self._lookups:
                raise ValueError(f"no replica for row shard {s}")

        with open(os.path.join(export_path, "meta.json")) as f:
            self.meta = json.load(f)
        self.step = self.meta["step"]
        with open(os.path.join(export_path, "dense.msgpack"), "rb") as f:
            self.module = load_module(task, f.read(), self.device)
        serialization.load_model_state(export_path, self.module)
        self._batchers = {t: Batcher(expected_unique=unique_cap)
                          for t in self.tables}
        # remote lookups are independent per (table, shard): fan them out
        # concurrently (the reference's entry graph sends its remote
        # predicts to all PS shards in parallel too)
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max(2, self.num_row_shards * 2))

    def _gather(self, tname: str, flat: np.ndarray):
        """The table's unique rows of a request, merged from the shards:
        (buffer [N * cap, dim] f32, flat int32 index into it)."""
        N, cap = self.num_row_shards, self.unique_cap
        # dedup grouped by OWNING SHARD: unique[s] is exactly the id list
        # to fetch from replica s, and index already points into the merged
        # [N * cap] buffer
        unique, index, counts, overflow = self._batchers[tname].dedup(
            flat, num_shards=N, shard_cap=cap)
        if overflow:
            # unique_cap is a per-request limit: overflowed ids would
            # silently serve zero embeddings (index -1), unlike training,
            # which surfaces stats['overflow']; refuse loudly instead
            raise ValueError(
                f"predict request exceeds unique_cap={cap} per shard for "
                f"table {tname} ({overflow} unique ids overflowed); split "
                f"the request or raise unique_cap")
        buf = np.zeros((N * cap, self.tables[tname].dim), np.float32)
        pending = {
            s: self._pool.submit(self._lookups[s], tname,
                                 unique[s, :int(counts[s])].copy())
            for s in range(N) if int(counts[s])}
        for s, fut in pending.items():
            vals = np.asarray(fut.result())
            buf[s * cap:s * cap + len(vals)] = vals
        return buf, index

    def predict(self, fid_batch: Dict[str, np.ndarray],
                batch: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        batch = batch or {}
        dev = self.device
        gathered = {}
        for tname, fnames in self.table_features.items():
            streams = [np.ascontiguousarray(fid_batch[f], np.int64)
                       for f in fnames]
            flat = np.concatenate([s.ravel() for s in streams])
            gathered[tname] = (*self._gather(tname, flat),
                               [s.shape for s in streams])
        with torch.inference_mode():
            pooled = {}
            for tname, (buf, index, shapes) in gathered.items():
                pooled.update(pool_table(
                    torch.from_numpy(buf).to(dev, non_blocking=True),
                    torch.from_numpy(index).to(dev, non_blocking=True),
                    [self.features[f] for f in self.table_features[tname]],
                    shapes))
            out = self.module(pooled, batch_tensors(batch, dev))
            preds = self.task.predictions(out)
        return preds.cpu().numpy()

    def close(self) -> None:
        """Stop the lookup threads."""
        self._pool.shutdown()

"""Realtime (streaming) training: minibatches from an unbounded stream,
touched-key tracking, a periodic push of the touched rows to serving
replicas, and dense-only fast checkpoints.

The engine records the fids each step touches in its host stores
(`EngineConfig(record_touch=True)`); every sync interval the streaming loop
drains them, gathers JUST their rows from the device pool (`table.lookup`
on the packed state: K1 on the card) and pushes (fids, embeddings) through
`sync_manager`, any object with `push(table, fids, values)`. The gather runs
at a power-of-two padded length, which bounds the distinct launch shapes
across rounds, and only those rows cross to the host: a round costs what
the touched rows cost, never what the pool does.

A sharded trainer pushes per shard, as the JAX package's multi-process
run does: each rank drains the touched ids of its own shard's store,
gathers those rows from its own pool and pushes them (a `ShardedTrainer`
rank, which holds every shard's store, drains the others' and leaves
their rows to their ranks).

Every `evict_interval_steps` steps the loop runs expiry at now minus the
largest ttl of the tables: a tiered trainer spills the expired rows to its
host archive (`spill_expired`), any other evicts and zeroes them
(`evict_expired`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.training import checkpoint as ckpt_lib

log = logging.getLogger(__name__)


@dataclasses.dataclass
class StreamingConfig:
    sync_interval_steps: int = 50          # push deltas every N steps
    dense_ckpt_interval_steps: int = 0     # 0 = off
    full_ckpt_interval_steps: int = 0
    evict_interval_steps: int = 0          # 0 = off
    ckpt_dir: Optional[str] = None
    max_push_rows: int = 1 << 20


class StreamingTrainer:
    def __init__(self, trainer, sync_manager=None,
                 config: StreamingConfig = StreamingConfig()):
        self.trainer = trainer
        self.sync = sync_manager
        self.config = config
        if not trainer.config.engine.record_touch and sync_manager is not None:
            raise ValueError("engine.record_touch must be True for realtime "
                             "parameter sync (EngineConfig(record_touch=True))")
        self.pushed_rows = 0
        self.sync_rounds = 0

    @staticmethod
    def _pad_cap(n: int) -> int:
        """Power-of-two bucket >= n, at least 512: bounds the distinct
        gather shapes across sync rounds."""
        p = 512
        while p < n:
            p <<= 1
        return p

    @torch.no_grad()
    def sync_now(self) -> Dict[str, int]:
        """Drain touched fids and push their rows to serving (one sync
        round). Per table: drain the touched fids -> host map to rows ->
        device gather of just those rows, -1 padded -> small copy to the
        host -> retrievers -> push. A sharded trainer's rank pushes its own
        shard's rows."""
        if self.sync is None:
            return {}
        t = self.trainer
        pushed = {}
        for tname, spec in t.engine.tables.items():
            for s, other in enumerate(t.engine.shard_stores[tname]):
                if other is not None and s != t.engine.shard:
                    other.drain_touched()   # their own ranks push them
            store = t.engine.store_of(tname)
            fids = store.drain_touched(cap=self.config.max_push_rows)
            if fids.size == 0:
                continue
            rows = store.lookup(fids)
            ok = rows >= 0
            fids, rows = fids[ok], rows[ok]
            n = fids.size
            if n == 0:
                continue
            rows_p = np.full(self._pad_cap(n), -1, np.int32)
            rows_p[:n] = rows
            vals = table_lib.lookup(
                spec, t.table_states[tname],
                torch.from_numpy(rows_p).to(t.device))[:n].cpu().numpy()
            # serve the retrieved (quantization-aware) view, matching what
            # training's forward pass saw
            off = 0
            for seg in spec.segments:
                if seg.retriever is not None:
                    vals[:, off:off + seg.dim] = seg.retriever.retrieve(
                        vals[:, off:off + seg.dim], t.step)
                off += seg.dim
            acks = self.sync.push(tname, fids, vals)
            pushed[tname] = n
            log.info("param sync: table %s pushed %d rows -> %s",
                     tname, n, acks)
        self.pushed_rows += sum(pushed.values())
        self.sync_rounds += 1
        return pushed

    def _expire(self) -> None:
        """Expiry at now minus the largest ttl of the tables: spill to the
        host archive when tiered, else free and zero the rows."""
        t = self.trainer
        ttl = max((spec.eviction.ttl_seconds
                   for spec in t.engine.tables.values()
                   if spec.eviction.ttl_seconds > 0), default=0)
        if not ttl:
            return
        now = int(time.time())
        if t.config.engine.tiered:
            t.spill_expired(now - ttl)
        else:
            t.evict_expired(now - ttl)

    def run(self, data: Iterable, max_steps: Optional[int] = None) -> Dict:
        """Consume a (possibly unbounded) stream of (fid_batch, batch)."""
        t = self.trainer
        cfg = self.config
        n = 0
        for fid_batch, batch in data:
            t.train_step(fid_batch, batch)
            n += 1
            if self.sync is not None and cfg.sync_interval_steps and \
                    n % cfg.sync_interval_steps == 0:
                self.sync_now()
            if cfg.ckpt_dir and cfg.dense_ckpt_interval_steps and \
                    n % cfg.dense_ckpt_interval_steps == 0:
                ckpt_lib.save(t, cfg.ckpt_dir, dense_only=True)
            if cfg.ckpt_dir and cfg.full_ckpt_interval_steps and \
                    n % cfg.full_ckpt_interval_steps == 0:
                ckpt_lib.save(t, cfg.ckpt_dir)
            if cfg.evict_interval_steps and n % cfg.evict_interval_steps == 0:
                self._expire()
            if max_steps is not None and n >= max_steps:
                break
        if self.sync is not None:
            self.sync_now()  # final flush
        t._drain_metrics()  # metrics accumulate on the device
        return {"steps": n, "pushed_rows": self.pushed_rows,
                "sync_rounds": self.sync_rounds,
                "auc": t.auc.result(), "loss": t.loss_mean.result()}

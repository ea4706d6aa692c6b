"""The multi-host trainer: each rank holds only its own table shard's host
store and parses only its own slice of the batch; the ids travel to their
owners.

The port of the JAX package's `MultiHostTrainer` (parallel/multihost.py),
Monolith's full-sync all-to-all step, as one process a rank (`make_mesh`):
NCCL on the cards, gloo on the CPU. Rank r of S holds the host store (and,
tiered, the archive) of shard r alone (`EngineConfig.local_shards =
(r,)`, None for the other shards), so host memory and host work per rank
no longer grow with S. `train_step(fid_batch, batch)` takes the RANK'S
batch, b rows of the global S * b: the rows [r*b, (r+1)*b) that the JAX
package's one process hands its device r. A step:

  host, requester:  `_prepare_local`: one dedup of the rank's ids into S
          buckets of `effective_bucket_cap` ids (`Batcher.dedup_counts`),
          the JAX wire [S, T*3*cap] int32, per table (sorted names)
          ids_hi | ids_lo | occurrences; the index matrices into the [S*cap]
          receive buffer stay on the host
  a2a#1   the wire's row s to owner s: `all_to_all_single` of CPU tensors
          over a gloo group made beside the mesh's (the ids are host data
          at both ends; JAX runs this exchange on the device and maps inside
          its step with `io_callback` only because XLA has no other route)
  host, owner:  `_map_ids`: dedup of the received ids, the requesters'
          occurrences summed per unique id for admission, `map_train_pos`
          in the rank's own store, the new-row mask, bucket -> unique
          positions [S, cap], and, tiered, the revive of archived rows from
          the rank's own archive
  upload  the owner's arrays, the index matrices and the batch's words in
          one int32 wire and one pinned copy (the Trainer's); revived rows
          beside it
  device  K1 gathers the rank's unique rows, then the init select and the
          revive overlay (`engine.fused_lookup`) -> the bucket gather ->
          a2a#2, ONE `all_to_all_single` per wire dtype over all tables
          (bf16 tables exchange in bf16) -> the receive buffer, the autograd
          leaf -> pooling and the dense forward/backward on the rank's
          slice -> all_reduce mean of the dense gradients, the loss and the
          model state -> a2a#3, the gradient's `all_to_all_single` per wire
          dtype, then `index_add_` into [U, D], divided by S -> row
          optimize, [K3 for a bf16 pool], K2

So a step makes 1 + 2 x (wire dtypes) all-to-alls. The host phases (local
prepare, a2a#1, owner map, pack) run when the step's wire is packed: in
`stage_block` a block ahead, on the calling thread (`_stage_overlaps` is
False: a2a#1 must not run beside the step's collectives), so admission
happens at staging time as in the single-device Trainer (the JAX
package's callback admits when the device step runs; the host stores see
the same calls in the same order either way). Blocks (`stage_block` /
`train_step_block`, synchronous or with `async_optimize` the 1-step-stale
schedule) and `train()` are the Trainer's own through its seams; a tiered
trainer runs blocks too, its revived rows taken at each step's pack.

With `EngineConfig(packed="off")` the owner's mask and revive positions
are the same; the step initialises the rows under the mask and restores
the revived ones (`engine.admit_rows`) before its `index_select`, and
updates each array with K3 on a bf16 table's params, keyed per (step,
table, shard) as the JAX package's multi-host trainer keys it.

`evaluate` maps read-only (`_map_ids(train=False)`: lookups, nothing
admitted) through the same exchanges; every rank returns the global AUC
and loss (the histograms summed by all_reduce). `predict` answers the
global batch. `evict_expired` / `spill_expired` run on the rank's own
store and zero the freed rows of its own pool at once with K2 (the JAX
package defers that zeroing into its next step only because a JAX process
cannot address a global array outside jit). Checkpoints, exports and the
streaming push run per shard (training/checkpoint.py, serving/export.py,
training/streaming.py).

The collectives reduce in another order than JAX's: the sparse gradients
and the dense mean agree with the JAX trainer to f32 rounding, not bit for
bit. At S = 1 (one card) every collective is a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from monolith_tpu_torch.embedding.engine import pad_rows
from monolith_tpu_torch.embedding.host_store import Batcher
from monolith_tpu_torch.embedding.tiered import state_width
from monolith_tpu_torch.metrics import (StreamingAUC, StreamingMean,
                                        device_metrics_init,
                                        device_metrics_update)
from monolith_tpu_torch.parallel.mesh import Mesh
from monolith_tpu_torch.parallel.sharded import ShardedTrainer
from monolith_tpu_torch.training.task import RecTask
from monolith_tpu_torch.training.trainer import (_WIRE_DTYPES, Trainer,
                                                 TrainerConfig)
from monolith_tpu_torch.utils.tracing import span


def _split64(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 ids as (high, low) int32 words."""
    a = a.astype(np.int64)
    return (a >> 32).astype(np.int32), (a & 0xFFFFFFFF).astype(np.int32)


def _join64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)


def _wire_dtype(spec) -> torch.dtype:
    """A table's embedding-exchange dtype: bf16 for a bf16 table without
    retrievers (lossless forward: the rows came from a bf16 pool; half the
    bytes of a2a#2 and a2a#3, whose gradient then rides bf16 too), f32
    otherwise."""
    if (spec.dtype == torch.bfloat16
            and all(s.retriever is None for s in spec.segments)):
        return torch.bfloat16
    return torch.float32


class MultiHostTrainer(ShardedTrainer):
    """A trainer whose rank `mesh.rank` holds table shard `mesh.rank` of S
    = mesh.size and its host store alone, and feeds its own batch slice.
    Requires config.engine.num_shards == S."""

    def __init__(self, task: RecTask, config: TrainerConfig, mesh: Mesh):
        config = dataclasses.replace(config, engine=dataclasses.replace(
            config.engine, local_shards=(mesh.rank,)))
        super().__init__(task, config, mesh)
        e = config.engine
        self._local_batchers = {t: Batcher(e.unique_cap)
                                for t in self._tables()}
        self._owner_batchers = {t: Batcher(e.unique_cap)
                                for t in self._tables()}
        # a2a#1's group: made now, when every rank makes it
        self.host_group  # noqa: B018

    # ------------------------------------------------------------------
    # host: the requester's buckets, a2a#1, the owner's map
    # ------------------------------------------------------------------

    def _prepare_local(self, fid_batch: Dict[str, np.ndarray]
                       ) -> Tuple[np.ndarray, Dict, Dict]:
        """The rank's ids bucketed by owner: (wire [S, T*3*cap] int32, per
        table ids_hi | ids_lo | occurrences of cap ids each, -1 / 0
        padded; index {table: {feature: [b, L] int32}} into the [S*cap]
        receive buffer, -1 for padding or overflow; stats {"overflow":
        {table: ids dropped for a full bucket}}). The JAX package's
        `_prepare_local` of one device, array for array."""
        S, cap = self.mesh.size, self.config.engine.effective_bucket_cap
        tnames = self._tables()
        wire = np.empty((S, len(tnames) * 3 * cap), np.int32)
        index: Dict[str, Dict[str, np.ndarray]] = {}
        stats = {"overflow": {}}
        for ti, tname in enumerate(tnames):
            feats = self.engine.table_features[tname]
            streams = [np.ascontiguousarray(fid_batch[f.name], np.int64)
                       .reshape(len(fid_batch[f.name]), -1) for f in feats]
            unique, idx, _, occ, overflow = \
                self._local_batchers[tname].dedup_counts(
                    np.concatenate([st.ravel() for st in streams]),
                    num_shards=S, shard_cap=cap)
            index[tname], off = {}, 0
            for f, st in zip(feats, streams):
                index[tname][f.name] = idx[off:off + st.size].reshape(st.shape)
                off += st.size
            base = ti * 3 * cap
            wire[:, base:base + cap], wire[:, base + cap:base + 2 * cap] = \
                _split64(unique)
            wire[:, base + 2 * cap:base + 3 * cap] = occ
            stats["overflow"][tname] = overflow
        return wire, index, stats

    def _send_ids(self, wire: np.ndarray) -> np.ndarray:
        """a2a#1: row s of this rank's wire to owner s; returns [S, W],
        row r = requester r's buckets for this rank."""
        send = torch.from_numpy(wire)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.host_group)
        return recv.numpy()

    def _map_ids(self, recv: np.ndarray, ts: int, train: bool = True):
        """The owner's map of the received ids, in its own store: (rows
        [T, U] int32 (-1 invalid), positions [T, S, cap] int32 (bucket ->
        unique slot, -1 padding), new-row mask [T, U] uint8, revive
        {table: (positions [m], values [m, width])} or None). Training
        admits (`map_train_pos`, with the requesters' occurrences summed
        per unique id when the table has admission) and, tiered, revives
        newly admitted ids from the rank's archive: the n revived rows,
        padded to a power of two with position -1. `train=False` only
        looks up (evaluation), with no revive. The JAX package's map
        callback, array for array (its revive ships [new_cap, width])."""
        e = self.config.engine
        S, cap, U = self.mesh.size, e.effective_bucket_cap, e.unique_cap
        tnames = self._tables()
        T = len(tnames)
        rows = np.full((T, U), -1, np.int32)
        pos = np.empty((T, S, cap), np.int32)
        new_mask = np.zeros((T, U), np.uint8)
        revive = {} if train and e.tiered else None
        for ti, tname in enumerate(tnames):
            base = ti * 3 * cap
            ids = _join64(recv[:, base:base + cap],
                          recv[:, base + cap:base + 2 * cap])
            unique, index, counts, _ = self._owner_batchers[tname].dedup(
                ids.ravel(), 1, U)
            c = int(counts[0])
            store = self.engine.store_of(tname)
            spec = self.engine.tables[tname]
            if revive is not None:
                revive[tname] = (np.empty(0, np.int32),
                                 np.zeros((0, state_width(spec)), np.float32))
            if c and train:
                occ = None
                if spec.admission.kind != "none":
                    # each requester sent its own occurrences of every id
                    # it asked for: their sum is the global batch's count
                    cnt = recv[:, base + 2 * cap:base + 3 * cap].ravel()
                    valid = index >= 0
                    occ_sum = np.zeros(U, np.int32)
                    np.add.at(occ_sum, index[valid], cnt[valid])
                    occ = occ_sum[:c]
                r, _, nf, npos = store.map_train_pos(
                    unique[0, :c], ts=ts, new_cap=e.new_cap, counts=occ,
                    record_touch=e.record_touch)
                rows[ti, :c] = r
                new_mask[ti, npos] = 1
                if revive is not None and len(nf):
                    ok, vals = self.engine.archive_of(tname).revive(nf)
                    if ok.any():
                        p = pad_rows(npos[ok])
                        values = np.zeros((len(p), vals.shape[1]), np.float32)
                        values[:ok.sum()] = vals[ok]
                        revive[tname] = (p, values)
            elif c:
                rows[ti, :c] = store.lookup(unique[0, :c])
            pos[ti] = index.reshape(S, cap)
        return rows, pos, new_mask, revive

    # ------------------------------------------------------------------
    # the rank's wire: the owner's rows, mask and positions, the index
    # matrices and the rank's batch
    # ------------------------------------------------------------------

    def _full_wire_words(self, layout) -> int:
        e, S = self.config.engine, self.mesh.size
        b = layout[0][2][0]
        words = sum(2 * e.unique_cap + S * e.effective_bucket_cap
                    + sum(b * f.max_length
                          for f in self.engine.table_features[t])
                    for t in self._tables())
        return words + sum(int(np.prod(s)) for _, _, s in layout)

    def _pack_full_wire(self, fid_batch, batch, layout, ts, stepno, out):
        """The host phases of one step (local prepare, a2a#1, the owner's
        map) and the pack of their arrays into `out`. Returns (stats,
        revive)."""
        off = 0

        def put(a):
            nonlocal off
            a = np.asarray(a).ravel()
            out[off:off + a.size] = a
            off += a.size

        with span("stage.prepare", stepno):
            wire, index, stats = self._prepare_local(fid_batch)
            rows, pos, mask, revive = self._map_ids(
                self._send_ids(wire), ts, train=not self._eval_wire)
            for ti, tname in enumerate(self._tables()):
                put(rows[ti])
                put(mask[ti])
                put(pos[ti])
                for f in self.engine.table_features[tname]:
                    put(index[tname][f.name])
        with span("stage.copy_batch", stepno):
            for k, _, _ in layout:
                put(np.ascontiguousarray(batch[k]).view(np.int32))
        return stats, revive

    def _decode(self, wire: torch.Tensor, layout):
        """The rank's inputs {table: {"rows" [U], "new_mask" [U],
        "bucket_idx" [S, cap], "index" {feature: [b, L]}}} and its batch,
        as views of the wire."""
        e, S = self.config.engine, self.mesh.size
        U, cap, b = e.unique_cap, e.effective_bucket_cap, layout[0][2][0]
        inputs, off = {}, 0

        def take(n):
            nonlocal off
            off += n
            return wire[off - n:off]

        for tname in self._tables():
            inputs[tname] = {
                "rows": take(U), "new_mask": take(U).to(torch.uint8),
                "bucket_idx": take(S * cap).reshape(S, cap),
                "index": {f.name: take(b * f.max_length).reshape(
                    b, f.max_length)
                    for f in self.engine.table_features[tname]}}
        batch_t = {k: take(int(np.prod(shape))).view(_WIRE_DTYPES[dstr])
                   .reshape(shape) for k, dstr, shape in layout}
        return inputs, batch_t

    # ------------------------------------------------------------------
    # device: a2a#2 and a2a#3, one all_to_all_single per wire dtype
    # ------------------------------------------------------------------

    def _dtype_groups(self, tnames) -> Dict[torch.dtype, List[str]]:
        groups: Dict[torch.dtype, List[str]] = {}
        for t in sorted(tnames):
            groups.setdefault(_wire_dtype(self.engine.tables[t]), []).append(t)
        return groups

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.mesh.group)
        return out

    def _exchange(self, unique: Dict[str, torch.Tensor], inputs: Dict
                  ) -> Dict[str, torch.Tensor]:
        """a2a#2: this rank's unique rows [U, D] -> its buckets for each
        requester [S, cap, D] (-1 reads zero) -> exchanged, every table of
        a wire dtype in one `all_to_all_single` -> the [S*cap, D] f32
        buffer each table's index matrices address."""
        S = self.mesh.size
        out = {}
        for dt, names in self._dtype_groups(unique).items():
            pieces = []
            for t in names:
                u = unique[t]
                bidx = inputs[t]["bucket_idx"]
                padded = torch.cat([u, u.new_zeros((1, u.shape[1]))])
                safe = torch.where(bidx < 0, u.shape[0], bidx).long()
                pieces.append(padded.index_select(0, safe.reshape(-1))
                              .reshape(S, -1).to(dt))
            recv, off = self._a2a(torch.cat(pieces, dim=1)), 0
            for t, p in zip(names, pieces):
                w = p.shape[1]
                out[t] = recv[:, off:off + w].float().reshape(
                    -1, unique[t].shape[1])
                off += w
        return out

    def _exchange_back(self, grads: Dict[str, torch.Tensor], inputs: Dict
                       ) -> Dict[str, torch.Tensor]:
        """a2a#3: the gradients wrt the receive buffers, back to their
        owners in the wire dtype (one `all_to_all_single` a dtype), then
        summed into this rank's unique rows [U, D] by bucket (`index_add_`)
        and divided by S."""
        S, U = self.mesh.size, self.config.engine.unique_cap
        out = {}
        for dt, names in self._dtype_groups(grads).items():
            pieces = [grads[t].reshape(S, -1).to(dt) for t in names]
            back, off = self._a2a(torch.cat(pieces, dim=1)), 0
            for t, p in zip(names, pieces):
                w, D = p.shape[1], grads[t].shape[1]
                g = back[:, off:off + w].float().reshape(-1, D)
                off += w
                bidx = inputs[t]["bucket_idx"]
                safe = torch.where(bidx < 0, U, bidx).long().reshape(-1)
                out[t] = g.new_zeros((U + 1, D)).index_add_(0, safe, g)[:U] / S
        return out

    # ------------------------------------------------------------------

    def _block_capable(self) -> bool:
        """Blocks always, tiered too: a step's revived rows are taken at
        its own pack, in step order."""
        return True

    def _attach_revive(self, inputs, revive) -> None:
        """The owner's revived rows travel as positions into its rows in
        either layout (a structure-of-arrays engine's admit_rows reads the
        rows at them), as the JAX package's map callback ships them."""
        for tname, (pos, values) in revive.items():
            inputs[tname]["revive_pos"] = pos
            inputs[tname]["revive_values"] = values

    @torch.no_grad()
    def evaluate(self, data, max_steps: Optional[int] = None
                 ) -> Dict[str, float]:
        """Forward only over the ranks' batches (data yields this rank's
        (fid_batch, batch)); nothing is admitted, missing ids read zeros.
        The AUC histograms are summed over the ranks by all_reduce and the
        loss averaged, so every rank returns the global AUC and loss."""
        auc, loss_mean = StreamingAUC(), StreamingMean()
        for i, (fid_batch, batch) in enumerate(data):
            if max_steps is not None and i >= max_steps:
                break
            out, batch_t = self._eval_forward(fid_batch, batch)
            loss, _ = self.task.loss(out, batch_t)
            preds = self.task.predictions(out)
            m = device_metrics_init(auc.num_thresholds, self.device)
            label = batch_t.get("label")
            if label is not None and isinstance(preds, torch.Tensor):
                device_metrics_update(m, loss, preds, label)
            hist = torch.cat([m["pos"], m["neg"]])
            dist.all_reduce(hist, group=self.mesh.group)
            hist = hist.cpu().numpy()
            auc.update_histograms(hist[:auc.num_thresholds],
                                  hist[auc.num_thresholds:])
            loss_mean.update(float(self._mean(loss)))
        return {"auc": auc.result(), "loss": loss_mean.result()}

    def spill_expired(self, expire_before: int) -> Dict[str, int]:
        """Two-tier expiry on this rank's own host store and archive (the
        Trainer's spill of its one shard); returns this rank's spilled
        counts."""
        return Trainer.spill_expired(self, expire_before)

    def evict_expired(self, expire_before: int) -> Dict[str, np.ndarray]:
        """Expiry on this rank's own host store; its freed rows are zeroed
        in its pool at once (one K2 a table). Returns the freed rows as
        rank * capacity + row, as the JAX package numbers shard rows."""
        freed = self.engine.evict_expired(expire_before)
        self.engine.zero_rows(self.table_states, {
            t: rows - self.mesh.rank * self.engine.tables[t].capacity_per_shard
            for t, rows in freed.items()})
        return freed

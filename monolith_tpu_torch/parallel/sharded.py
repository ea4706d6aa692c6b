"""The sharded trainer: embedding tables row-sharded over the ranks of a
torch.distributed group, the dense tower data-parallel.

The port of the JAX package's `ShardedTrainer` (shard_map over a 1-axis
mesh) as one process a rank (`make_mesh`): NCCL on the cards, gloo on the
CPU. Its step, on rank r of S:

  host:   every rank runs the same host prepare over the WHOLE global
          batch (the engine holds all S host stores, as the JAX package's
          one host engine does for its S devices), then packs its own part
          into one int32 wire: shard r's rows and new-row mask, its batch
          slice [r*B/S, (r+1)*B/S) of every index matrix and batch array
          (and for a2a its buckets), sent with one copy
  device: K1 gathers shard r's unique packed rows [U, P] from its pool,
          new-row init as a select, keyed by (seed, step, table, r) ->
          the exchange forward -> pool + dense fwd/bwd on the batch slice
          -> all_reduce mean of the dense gradients (and of the loss and
          the model state) -> clip -> dense update, identical on every
          rank -> the exchange backward -> row optimize -> [K3] -> K2

The exchanges sit outside autograd, around its leaves:

  allgather  all_gather_into_tensor of [U, D] -> [S*U, D], the leaf; its
             gradient goes back by reduce_scatter_tensor (sum) -> [U, D]
  a2a        buckets unique[bucket_idx[r]] -> [S, cap, D] (-1 reads zero),
             all_to_all_single -> the receive buffer [S*cap, D], the leaf;
             its gradient goes back by all_to_all_single, then index_add_
             into [U, D] by bucket_idx (the transpose JAX's autodiff makes)

and the sparse gradient is divided by S, for the global-mean loss. The
trainer is the single-device Trainer with its seams filled in
(training/trainer.py), so blocks (`stage_block`, `train_step_block`,
synchronous and 1-step-stale asynchronous) and `train()` are the same
code, and a block equals its steps bit for bit. `evaluate` and `predict`
always take the allgather exchange, whatever the training one, as in the
JAX package. Returned predictions are the global batch's [B], as the JAX
trainer's `out_specs=P(ax)`; the metrics see them with the global labels.
The auxiliary losses are this rank's.

With `EngineConfig(packed="off")` a rank holds its shard as the
structure-of-arrays state: its wire carries new_pos / new_rows [K] in place
of the mask, and the step is the Trainer's multi-array one (admit_rows,
`index_select`, apply_gradients) through the same seams; K3 is keyed by
(seed, step, table, rank), where the JAX package's ShardedTrainer rounds
every shard with one key a step (ROADMAP §3 R6). Its blocks step
synchronously, as the JAX package's do on that layout.

Checkpoints, deltas, exports and the streaming push run per shard (every
rank calls them): rank r writes and pushes shard r, and restores every
host store it holds with its own pool (training/checkpoint.py).

Tiered storage (`EngineConfig(tiered=True)`): rank r holds every shard's
host store but only its own shard's archive (an archive holds 4x a shard's
rows). Every rank's prepare maps the whole batch in every store, as
before; the revives of shard r's newly admitted ids come from rank r's
archive alone and travel beside its wire as the Trainer's do ("revive_pos"
or, structure of arrays, "revive_rows", with "revive_values"), laid over
the init in the step, blocks included. `spill_expired` evicts the expired
ids from every store on every rank, so the stores stay identical; rank r
gathers its own shard's expired rows with one K1, archives them and zeroes
them (K2), and every rank returns the spilled counts summed over the ranks,
as the JAX trainer's `spill_expired` returns every shard's.

The collectives reduce in another order than JAX's `psum_scatter`: the
sparse gradients and the dense mean agree with the JAX trainer to f32
rounding, not bit for bit. At S = 1 (one card) every collective is the
identity.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from monolith_tpu_torch.parallel.mesh import Mesh
from monolith_tpu_torch.training.task import RecTask
from monolith_tpu_torch.training.trainer import (_WIRE_DTYPES, Trainer,
                                                 TrainerConfig)
from monolith_tpu_torch.utils.tracing import span


class ShardedTrainer(Trainer):
    """A Trainer whose tables hold shard `mesh.rank` of S = mesh.size.
    Requires config.engine.num_shards == S and a batch that divides by
    S."""

    def __init__(self, task: RecTask, config: TrainerConfig, mesh: Mesh):
        e = config.engine
        if e.num_shards != mesh.size:
            raise ValueError(f"engine.num_shards ({e.num_shards}) must equal "
                             f"mesh size ({mesh.size})")
        if e.unique_caps or e.new_caps:
            raise ValueError("the sharded trainers use the global caps "
                             "(no per-table unique_caps/new_caps)")
        self.mesh = mesh
        self._eval_wire = False
        self._host_group = None
        super().__init__(task, config, device=mesh.device)

    def _own_shard(self) -> int:
        return self.mesh.rank

    @property
    def host_group(self):
        """A gloo group over the mesh's ranks, for host data and barriers
        (checkpoints, exports): the mesh's own group when it is gloo, else
        one made at first use. Making it is collective: every rank asks at
        the same point of the run."""
        if self._host_group is None:
            self._host_group = (self.mesh.group if self.mesh.backend == "gloo"
                                else dist.new_group(backend="gloo"))
        return self._host_group

    def _barrier(self) -> None:
        dist.barrier(group=self.host_group)

    # ------------------------------------------------------------------
    # the rank's wire: its shard's rows and mask, its batch slice
    # ------------------------------------------------------------------

    def _a2a_wire(self) -> bool:
        return self.config.engine.exchange == "a2a" and not self._eval_wire

    def _tables(self) -> List[str]:
        return [t for t in sorted(self.engine.table_features)
                if self.engine.table_features[t]]

    def _slice_rows(self, layout) -> int:
        B, S = layout[0][2][0], self.mesh.size
        if B % S:
            raise ValueError(f"batch {B} does not divide into {S} ranks")
        return B // S

    def _full_wire_words(self, layout) -> int:
        e, S = self.config.engine, self.mesh.size
        b = self._slice_rows(layout)
        words = 0
        for tname in self._tables():
            words += e.unique_cap + self._new_words() + sum(
                b * f.max_length for f in self.engine.table_features[tname])
            if self._a2a_wire():
                words += S * e.effective_bucket_cap
        return words + sum(int(np.prod(s)) // S for _, _, s in layout)

    def _new_words(self) -> int:
        """Words of a table's new-row channel: the mask [U] of a packed
        engine, new_pos or new_rows [K] of a structure-of-arrays one."""
        e = self.config.engine
        return e.unique_cap if self.engine.packed else e.new_cap

    def _pack_full_wire(self, fid_batch, batch, layout, ts, stepno, out):
        """The host prepare of the whole batch (every rank makes the same
        decisions), then this rank's part of it into `out`. Returns (stats,
        revive): a tiered engine's revived rows of this rank's shard
        {table: (positions or rows, values)}, else None."""
        off = 0

        def put(a):
            nonlocal off
            a = np.asarray(a).ravel()
            out[off:off + a.size] = a
            off += a.size

        r, b = self.mesh.rank, self._slice_rows(layout)
        with span("stage.prepare", stepno):
            if self._a2a_wire():
                inputs, stats = self.engine.prepare_batch_a2a(fid_batch,
                                                              ts=ts)
            else:
                inputs, stats = self.engine.prepare_shards(fid_batch, ts=ts)
            # the engine holds this rank's archive alone, so only row r
            # revives: its n rows padded to a power of two
            revive = self.engine.revive_of(inputs, shard=r)
            for tname in self._tables():
                tin = inputs[tname]
                put(tin["rows"][r])
                put(tin[_new_channel(tin)][r])
                if "bucket_idx" in tin:
                    put(tin["bucket_idx"][r])
                for f in self.engine.table_features[tname]:
                    put(tin["index"][f.name][r * b:(r + 1) * b])
        with span("stage.copy_batch", stepno):
            for k, _, _ in layout:
                put(np.ascontiguousarray(batch[k][r * b:(r + 1) * b]
                                         ).view(np.int32))
        return stats, revive

    def _decode(self, wire: torch.Tensor, layout):
        """The rank's inputs {table: {"rows" [U], the new-row channel
        ("new_mask" [U], or "new_pos" / "new_rows" [K] of a
        structure-of-arrays engine), ["bucket_idx" [S, cap]], "index"
        {feature: [B/S, L]}}} and its batch slice, as views of the
        wire."""
        e, S = self.config.engine, self.mesh.size
        U, b = e.unique_cap, self._slice_rows(layout)
        inputs, off = {}, 0

        def take(n):
            nonlocal off
            off += n
            return wire[off - n:off]

        new = ("new_mask" if self.engine.packed
               else "new_pos" if e.compact_wire else "new_rows")
        for tname in self._tables():
            tin = {"rows": take(U)}
            tin[new] = take(self._new_words())
            if new == "new_mask":
                tin[new] = tin[new].to(torch.uint8)
            if self._a2a_wire():
                cap = e.effective_bucket_cap
                tin["bucket_idx"] = take(S * cap).reshape(S, cap)
            tin["index"] = {f.name: take(b * f.max_length).reshape(
                b, f.max_length) for f in self.engine.table_features[tname]}
            inputs[tname] = tin
        batch_t = {}
        for k, dstr, shape in layout:
            n = int(np.prod(shape)) // S
            batch_t[k] = take(n).view(_WIRE_DTYPES[dstr]).reshape(
                (b,) + tuple(shape[1:]))
        return inputs, batch_t

    # ------------------------------------------------------------------
    # the seams of Trainer's step: exchanges and means over the ranks
    # ------------------------------------------------------------------

    def _exchange(self, unique: Dict[str, torch.Tensor], inputs: Dict
                  ) -> Dict[str, torch.Tensor]:
        """This rank's unique rows [U, D] -> the buffer its index matrices
        address: [S*U, D] (allgather) or [S*cap, D] (a2a)."""
        S, group = self.mesh.size, self.mesh.group
        out = {}
        for tname, u in unique.items():
            u = u.contiguous()
            bidx = inputs[tname].get("bucket_idx")
            if bidx is None:
                full = u.new_empty((S * u.shape[0], u.shape[1]))
                dist.all_gather_into_tensor(full, u, group=group)
                out[tname] = full
                continue
            # bucket d: the rows batch shard d reads from this shard
            padded = torch.cat([u, u.new_zeros((1, u.shape[1]))])
            safe = torch.where(bidx < 0, u.shape[0], bidx).long().reshape(-1)
            buckets = padded.index_select(0, safe)
            recv = torch.empty_like(buckets)
            dist.all_to_all_single(recv, buckets, group=group)
            out[tname] = recv
        return out

    def _exchange_back(self, grads: Dict[str, torch.Tensor], inputs: Dict
                       ) -> Dict[str, torch.Tensor]:
        """The gradients wrt the exchanged buffers -> wrt this rank's
        unique rows [U, D], summed over the ranks and divided by S."""
        S, group = self.mesh.size, self.mesh.group
        U = self.config.engine.unique_cap
        out = {}
        for tname, g in grads.items():
            g = g.contiguous()
            bidx = inputs[tname].get("bucket_idx")
            if bidx is None:
                gu = g.new_empty((g.shape[0] // S, g.shape[1]))
                dist.reduce_scatter_tensor(gu, g, group=group)
            else:
                back = torch.empty_like(g)
                dist.all_to_all_single(back, g, group=group)
                safe = torch.where(bidx < 0, U, bidx).long().reshape(-1)
                gu = g.new_zeros((U + 1, g.shape[1])).index_add_(
                    0, safe, back)[:U]
            out[tname] = gu / S
        return out

    def _all_mean(self, tensors: List[torch.Tensor]) -> None:
        """Each tensor replaced, in place, by its mean over the ranks: one
        all_reduce a dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=self.mesh.group)
            flat /= self.mesh.size
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def _reduce_dense(self, loss: torch.Tensor, gp: Dict[str, torch.Tensor]):
        """The ranks' mean of the loss, the dense gradients and the model
        state (the buffers the training forward updated), as the JAX
        trainer's pmean of each."""
        loss = loss.clone()
        self._all_mean([loss] + list(gp.values())
                       + [b for b in self.module.buffers()
                          if b.is_floating_point()])
        return loss, gp

    def _gather(self, preds):
        """The batch slices' predictions, in rank order: [B, ...]."""
        if isinstance(preds, dict):
            return {k: self._gather(v) for k, v in preds.items()}
        preds = preds.contiguous()
        out = preds.new_empty((self.mesh.size * preds.shape[0],)
                              + tuple(preds.shape[1:]))
        dist.all_gather_into_tensor(out, preds, group=self.mesh.group)
        return out

    def _mean(self, loss: torch.Tensor) -> torch.Tensor:
        loss = loss.detach().clone()
        self._all_mean([loss])
        return loss

    def _metrics_update(self, loss, preds, batch_t):
        """The global predictions against the global labels."""
        if not self.config.metrics_enabled:
            return
        label = batch_t.get("label")
        super()._metrics_update(
            loss, preds, {} if label is None else {"label": self._gather(label)})

    # ------------------------------------------------------------------

    def _block_capable(self) -> bool:
        """Blocks on every layout, as the JAX package's sharded trainer
        runs them (a structure-of-arrays block steps synchronously)."""
        return True

    def _graph_capable(self) -> bool:
        """No captured graphs: the step's seams (the exchanges, the dense
        mean, the gather) run collectives."""
        return False

    def _stage_overlaps(self) -> bool:
        """Every step packed on the calling thread: the pack runs every
        shard's prepare, and the multi-host one gloo collectives, which a
        second thread would interleave with the step's."""
        return False

    def _eval_forward(self, fid_batch, batch):
        """Forward only through the allgather exchange, whatever the
        training one (the JAX trainer's evaluate always all-gathers)."""
        self._eval_wire = True
        try:
            return super()._eval_forward(fid_batch, batch)
        finally:
            self._eval_wire = False

    def evict_expired(self, expire_before: int) -> Dict[str, np.ndarray]:
        """Expiry on every shard's host store (each rank holds all S and
        evicts the same ids); this rank zeroes its own shard's freed rows.
        Returns every shard's freed rows, shard s's as s * capacity +
        row."""
        freed = self.engine.evict_expired(expire_before)
        mine = {}
        for tname, rows in freed.items():
            cap = self.engine.tables[tname].capacity_per_shard
            mine[tname] = rows[rows // cap == self.mesh.rank] % cap
        self.engine.zero_rows(self.table_states, mine)
        return freed

    @torch.no_grad()
    def spill_expired(self, expire_before: int) -> Dict[str, int]:
        """Two-tier expiry: every shard's host store evicts its expired
        ids on every rank (the stores stay identical); this rank gathers
        its own shard's expired rows with one K1 a table, archives them in
        its own archive and zeroes them (K2). Returns the rows spilled by
        table, summed over the ranks (one all_reduce on the host group), as
        the JAX trainer returns every shard's."""
        if not self.config.engine.tiered:
            raise ValueError("spill_expired requires EngineConfig(tiered=True)")
        r = self.mesh.rank
        tnames = sorted(self.engine.tables)
        spilled, mine = torch.zeros(len(tnames), dtype=torch.int64), {}
        for i, tname in enumerate(tnames):
            for s, store in enumerate(self.engine.shard_stores[tname]):
                rows, fids = store.evict_expired(expire_before,
                                                 return_fids=True)
                if s == r:
                    mine[tname] = rows.astype(np.int64)
                    spilled[i] = self._spill(tname, rows, fids, expire_before)
        self.engine.zero_rows(self.table_states, mine)
        dist.all_reduce(spilled, group=self.host_group)
        return {t: int(n) for t, n in zip(tnames, spilled)}


def _new_channel(tin: Dict) -> str:
    """The key of a prepared table's new-row channel."""
    return next(k for k in ("new_mask", "new_pos", "new_rows") if k in tin)

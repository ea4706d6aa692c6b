"""The embedding engine: host id mapping + device row pools, end to end.

The port's single-shard fused path of the JAX package's engine. Each step:

  host (C++):  per table: concat feature fid streams -> dedup ->
               HostStore map -> pack one int32 wire  (prepare_wire)
  device:      decode_wire -> gather the unique packed rows (K1) with
               new-row init as a select (fused_lookup) -> per-feature
               gather + pool (pool_features) -> model fwd/bwd -> per-segment
               row optimize -> [bf16 pools: narrow, stochastically by K3]
               -> ONE scatter per table (K2, fused_apply)

Autograd through the per-feature gather produces the per-unique-row summed
gradients (an index-add into the unique buffer). Per-step shapes are fixed:
`unique_cap` unique ids per table, -1 padded; overflow ids read zeros and
receive no update.

The 1-step-stale asynchronous block (EngineConfig.async_optimize, driven by
training/trainer.py) splits fused_apply in two: `optimize_rows` (row math
only, on freshly gathered rows, with the rows the forward used handed to DC
segments) and `scatter_rows` (the deferred write-back, one K2 per table, a
step later).

Single-shard only: decoded inputs and table states carry no shard axis
(the JAX package's carry a leading axis of 1). Table pools are updated in
place by fused_apply and scatter_rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from monolith_tpu_torch.device import resolve_device
from monolith_tpu_torch.embedding import host_store
from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.embedding.host_store import Batcher, FilterKind, HostStore
from monolith_tpu_torch.embedding.spec import TableSpec
from monolith_tpu_torch.feature import FeatureConfig, combine

_FILTER_KINDS = {
    "none": FilterKind.NONE,
    "sliding": FilterKind.SLIDING,
    "probabilistic": FilterKind.PROBABILISTIC,
    "probabilistic_unequal": FilterKind.PROBABILISTIC_UNEQUAL,
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_shards: int = 1      # the port runs single-shard tables only
    unique_cap: int = 4096   # unique ids per table per step (<= 65535)
    new_cap: int = 1024      # admissions per table per step
    # per-table overrides of unique_cap/new_cap as ((table, cap), ...): a
    # history table needs a far larger per-step budget than scalar slots
    # (over-capping pads every gather and scatter, under-capping drops ids
    # as dedup overflow)
    unique_caps: Optional[Tuple[Tuple[str, int], ...]] = None
    new_caps: Optional[Tuple[Tuple[str, int], ...]] = None
    # 1-step-stale pipelined embeddings in block dispatch: step i's forward
    # gathers its rows BEFORE step i-1's write-back lands; the optimize
    # still runs on the latest rows (a second gather), so no update is
    # lost; ids read in consecutive steps see values one step stale in the
    # forward: pair hot segments with the DC optimizer to compensate. An
    # id admitted at step i and read again at step i+1 reads its row's
    # content from before the init in that forward only (zeros on a fresh
    # pool); the optimize and the write-back use initialised state.
    async_optimize: bool = False
    # record the fids each step touches in the host stores, for the
    # streaming push of touched rows (HostStore.drain_touched)
    record_touch: bool = False

    def ucap(self, table: str) -> int:
        if self.unique_caps:
            return dict(self.unique_caps).get(table, self.unique_cap)
        return self.unique_cap

    def ncap(self, table: str) -> int:
        if self.new_caps:
            return dict(self.new_caps).get(table, self.new_cap)
        return self.new_cap

    @property
    def max_ucap(self) -> int:
        caps = [self.unique_cap]
        if self.unique_caps:
            caps += [c for _, c in self.unique_caps]
        return max(caps)


# Three seed domains, one for each stream of random numbers of a step, told
# apart by the top two bits of the 64-bit seed so that no two can collide:
#
#   bit 63 = 0          new-row init         (JAX: the trainer's base key)
#   bits 63, 62 = 1, 0  fused_apply's K3     (JAX: PRNGKey(1))
#   bits 63, 62 = 1, 1  scatter_rows' K3     (JAX: PRNGKey(2))
#
# Below the domain bits each is the same mix of (seed, step, table index),
# as the JAX package folds step and table index into each of its keys.

def _seed_mix(seed: int, step: int, table_index: int) -> int:
    return (seed * 1_000_003 + step) * 1_009 + table_index


def _init_seed(seed: int, step: int, table_index: int) -> int:
    """Philox seed of one table's new-row init at one step."""
    return _seed_mix(seed, step, table_index) % (1 << 63)


def _round_seed(seed: int, step: int, table_index: int) -> int:
    """Philox key of one table's stochastic bf16 write-back (K3) in
    fused_apply at one step."""
    return _seed_mix(seed, step, table_index) % (1 << 62) | (1 << 63)


def _defer_seed(seed: int, step: int, table_index: int) -> int:
    """Philox key of one table's stochastic bf16 write-back (K3) in
    scatter_rows, the asynchronous block's deferred write-back."""
    return _seed_mix(seed, step, table_index) % (1 << 62) | (3 << 62)


class EmbeddingEngine:
    """Owns host state (stores/batchers) and the device-side functions."""

    def __init__(self, tables: Sequence[TableSpec],
                 features: Sequence[FeatureConfig],
                 config: EngineConfig = EngineConfig(),
                 seed: int = 0, device=None):
        if config.num_shards != 1:
            raise ValueError("the port's engine runs single-shard tables "
                             f"(num_shards=1, got {config.num_shards})")
        if config.max_ucap > 65535:
            # 16-bit feature indices (decoded unsigned, 0xFFFF sentinel) can
            # only address 65535 unique rows; a larger cap would alias rows
            raise ValueError(f"unique caps must be <= 65535 (got "
                             f"{config.max_ucap})")
        self.config = config
        self.device = resolve_device(device)
        self.tables: Dict[str, TableSpec] = {t.name: t for t in tables}
        self.features: Dict[str, FeatureConfig] = {f.name: f for f in features}
        for f in features:
            if f.table not in self.tables:
                raise ValueError(f"feature {f.name} references unknown table {f.table}")
        self.table_features: Dict[str, List[FeatureConfig]] = {
            t: [f for f in features if f.table == t] for t in self.tables}
        self.stores: Dict[str, HostStore] = {}
        self.batchers: Dict[str, Batcher] = {}
        for name, t in self.tables.items():
            if t.eviction.ttl_seconds > 0:
                raise NotImplementedError(f"table {name}: expiry eviction is "
                                          f"not ported yet")
            self.stores[name] = HostStore(
                row_capacity=t.capacity_per_shard,
                filter_kind=_FILTER_KINDS[t.admission.kind],
                admit_threshold=t.admission.threshold,
                filter_capacity=t.admission.filter_capacity,
                filter_splits=t.admission.filter_splits,
                seed=seed * 1000003)
            self.batchers[name] = Batcher(expected_unique=config.ucap(name))
        self._generator = torch.Generator(device=self.device)

    # ------------------------------------------------------------------
    # host side
    # ------------------------------------------------------------------

    def wire_words(self, batch_size: int) -> int:
        """Number of int32 words in the engine's wire region for a batch."""
        total = 0
        for tname, feats in self.table_features.items():
            if not feats:
                continue
            total += (self.config.ucap(tname)
                      + sum((batch_size * f.max_length + 1) // 2
                            for f in feats))
        return total

    def prepare_wire(self, fid_batch: Dict[str, np.ndarray], ts: int,
                     out: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, Dict]:
        """Fused host prepare: ONE native call runs dedup + store map + wire
        pack for ALL tables. Layout per table (sorted name order):

          [ucap(table) words]  row | (new << 30); -1 for invalid rows
          per feature (declared order): ceil(B*L/2) words of 16-bit indices

        Bit-identical to the JAX package's wire for the same store state and
        batch. Pass `out` (contiguous int32, exactly the engine wire length)
        to write into a larger caller-owned transfer buffer."""
        cfg = self.config
        names, streams_per_table = [], []
        offsets = [0]
        for tname in sorted(self.table_features):
            feats = self.table_features[tname]
            if not feats:
                continue
            streams = [np.ascontiguousarray(fid_batch[f.name], dtype=np.int64)
                       for f in feats]
            names.append(tname)
            streams_per_table.append(streams)
            offsets.append(offsets[-1] + cfg.ucap(tname)
                           + sum((s.size + 1) // 2 for s in streams))
        offsets = np.asarray(offsets, dtype=np.int64)
        total = int(offsets[-1])
        if out is not None:
            if out.size != total or out.dtype != np.int32:
                raise ValueError(f"wire buffer must be {total} int32 words "
                                 f"(got {out.size} {out.dtype})")
            wire = out
        else:
            wire = np.empty(total, dtype=np.int32)
        st = host_store.prepare_wire_multi(
            [self.batchers[t] for t in names],
            [self.stores[t] for t in names],
            streams_per_table, ts,
            [cfg.ucap(t) for t in names], [cfg.ncap(t) for t in names],
            cfg.record_touch, wire, offsets)
        stats = {"overflow": {}, "new": {}, "unique": {}, "filtered": {},
                 "new_rejected": {}}
        for i, tname in enumerate(names):
            stats["overflow"][tname] = int(st[i, 0])
            stats["new"][tname] = int(st[i, 1])
            stats["unique"][tname] = int(st[i, 2])
            stats["filtered"][tname] = int(st[i, 3])
            stats["new_rejected"][tname] = int(st[i, 4])
        return wire, stats

    # ------------------------------------------------------------------
    # device side
    # ------------------------------------------------------------------

    def create_states(self) -> Dict[str, table_lib.TableState]:
        """One packed pool per table on the engine's device."""
        return {name: table_lib.create_state(spec, self.device)
                for name, spec in self.tables.items()}

    def decode_wire(self, wire: torch.Tensor, batch_size: int) -> Dict:
        """Device-side inverse of the wire pack. Returns per table
        {"rows": [U] int32 (-1 invalid), "new_mask": [U] uint8,
         "index": {feature: [B, L] int32 (-1 invalid)}}."""
        inputs = {}
        off = 0
        for tname in sorted(self.table_features):
            feats = self.table_features[tname]
            if not feats:
                continue
            U = self.config.ucap(tname)
            rows_enc = wire[off:off + U]
            off += U
            invalid = rows_enc < 0
            mask = torch.where(invalid, 0, (rows_enc >> 30) & 1).to(torch.uint8)
            rows = torch.where(invalid, -1, rows_enc & ((1 << 30) - 1))
            index = {}
            for f in feats:
                n = batch_size * f.max_length
                words = (n + 1) // 2
                chunk = wire[off:off + words]
                off += words
                # 16-bit index words decode UNSIGNED (0xFFFF is the invalid
                # sentinel): view as int16, widen, mask to 16 bits
                idx = chunk.contiguous().view(torch.int16)[:n].to(torch.int32)
                idx = idx & 0xFFFF
                idx = torch.where(idx == 0xFFFF, -1, idx)
                index[f.name] = idx.reshape(batch_size, f.max_length)
            inputs[tname] = {"rows": rows.to(torch.int32),
                             "new_mask": mask, "index": index}
        return inputs

    def fused_lookup(self, states: Dict, inputs: Dict, seed: int, step: int
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Gather each table's packed rows (K1) and select init values for
        newly admitted ids. New-row init draws from Philox through a
        generator seeded from (seed, step, table index) — not the JAX
        package's threefry draws.

        Returns (prows {table: [U, P] f32}, unique {table: [U, dim] f32}),
        f32 for a bf16 pool too."""
        prows, unique = {}, {}
        for i, (tname, tin) in enumerate(sorted(inputs.items())):
            spec = self.tables[tname]
            rows = tin["rows"]
            p = table_lib.gather_packed(spec, states[tname], rows)
            self._generator.manual_seed(_init_seed(seed, step, i))
            init = table_lib.init_packed(spec, self._generator, rows.shape[0],
                                         self.device)
            p = torch.where((tin["new_mask"] > 0)[:, None], init, p)
            prows[tname] = p
            unique[tname] = table_lib.params_of(spec, p)
        return prows, unique

    def fused_apply(self, states: Dict, inputs: Dict, prows: Dict,
                    unique_grads: Dict[str, torch.Tensor], step: int,
                    seed: int = 0) -> Dict:
        """Optimize the gathered packed rows and write them back in place
        with ONE scatter (K2) per table; a bf16 pool with stochastic
        rounding narrows them first with K3, keyed by (seed, step, table
        index)."""
        for i, (tname, tin) in enumerate(sorted(inputs.items())):
            spec = self.tables[tname]
            new_p = table_lib.optimize_packed(spec, prows[tname],
                                              unique_grads[tname], step)
            table_lib.scatter_packed(spec, states[tname], tin["rows"], new_p,
                                     seed=_round_seed(seed, step, i))
        return states

    def optimize_rows(self, inputs: Dict, prows_latest: Dict,
                      unique_grads: Dict[str, torch.Tensor], step: int,
                      prows_stale: Optional[Dict] = None
                      ) -> Dict[str, torch.Tensor]:
        """Optimize gathered packed rows WITHOUT scattering them (the
        asynchronous block defers the write-back by one step).
        `prows_stale`: the rows the forward used, handed to DC segments."""
        return {tname: table_lib.optimize_packed(
                    self.tables[tname], prows_latest[tname],
                    unique_grads[tname], step,
                    stale=None if prows_stale is None else prows_stale[tname])
                for tname in sorted(inputs)}

    def scatter_rows(self, states: Dict, rows: Dict[str, torch.Tensor],
                     values: Dict[str, torch.Tensor], step: int,
                     seed: int = 0) -> Dict:
        """ONE scatter (K2) per table of full packed rows, in place; -1 rows
        drop: the deferred write-back of the asynchronous block. A bf16
        pool with stochastic rounding narrows the rows first with K3, keyed
        by (seed, step, table index) in a domain of its own
        (_defer_seed)."""
        for i, tname in enumerate(sorted(rows)):
            table_lib.scatter_packed(self.tables[tname], states[tname],
                                     rows[tname], values[tname],
                                     seed=_defer_seed(seed, step, i))
        return states

    def lookup_unique(self, states: Dict, inputs: Dict) -> Dict[str, torch.Tensor]:
        """Gather each table's unique rows (K1): {table: [U, dim] f32}, f32
        for a bf16 pool too."""
        return {tname: table_lib.lookup(self.tables[tname], states[tname],
                                        tin["rows"])
                for tname, tin in inputs.items()}

    def retrieve_unique(self, unique_embs: Dict[str, torch.Tensor],
                        step: int) -> Dict[str, torch.Tensor]:
        """Apply the per-segment quantization-aware retrievers
        (embedding/retrievers.py) to the unique-row buffers; identity for a
        table that configures none. It must be called inside the
        differentiated loss, so that autograd produces the retriever's
        backward (straight-through for FakeQuant). `step` is the trainer's
        step number, a host int."""
        out = {}
        for tname, buf in unique_embs.items():
            spec = self.tables[tname]
            if all(seg.retriever is None for seg in spec.segments):
                out[tname] = buf
                continue
            pieces, off = [], 0
            for seg in spec.segments:
                x = buf[:, off:off + seg.dim]
                pieces.append(seg.retriever.retrieve(x, step)
                              if seg.retriever is not None else x)
                off += seg.dim
            out[tname] = torch.cat(pieces, dim=-1)
        return out

    def pool_features(self, unique_embs: Dict[str, torch.Tensor],
                      inputs: Dict) -> Dict[str, torch.Tensor]:
        """Per-feature gather + combine from the unique buffers; index -1
        reads zeros. Differentiable wrt unique_embs: the gather is an
        index_select, whose backward is an index_add_ into the unique buffer
        (atomics on the card, so summation order varies run to run).
        Advanced indexing (`buf[idx]`) would give the same values, but its
        backward sorts the indices and took 6.8 ms of a 7.5 ms device step
        at the main path's shapes on an H100 (PERF.md).

        Scalar slots (max_length == 1, sum/mean combiners) sharing a table
        are batched into one gather, as in the JAX package."""
        pooled = {}
        for tname, tin in inputs.items():
            buf = unique_embs[tname]
            n = buf.shape[0]
            # row n of the padded buffer is the zero row that -1 reads
            padded = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])

            def gather(idx):
                safe = torch.where(idx < 0, n, idx).long()
                return padded.index_select(0, safe.reshape(-1)).reshape(
                    *safe.shape, padded.shape[1])

            scalars = []  # (fname, idx [B, 1]) — poolable in one gather
            for fname, idx in tin["index"].items():
                f = self.features[fname]
                if (f.max_length == 1 and idx.shape[-1] == 1
                        and f.combiner in ("sum", "mean")):
                    scalars.append((fname, idx))
                    continue
                pooled[fname] = combine(gather(idx), idx >= 0, f.combiner)
            if len(scalars) == 1:
                fname, idx = scalars[0]
                pooled[fname] = combine(gather(idx), idx >= 0,
                                        self.features[fname].combiner)
            elif scalars:
                idx = torch.cat([i for _, i in scalars], dim=1)  # [B, k]
                emb = gather(idx)  # [B, k, D]
                # sum/mean over a single valid element is the element
                # itself (invalid slots read zeros), so the per-slot
                # combine reduces to a column slice
                for j, (fname, _) in enumerate(scalars):
                    pooled[fname] = emb[:, j]
        return pooled

    def embed(self, states: Dict, inputs: Dict, step=0
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """lookup + retrieve + pool; returns (pooled features, unique
        buffers)."""
        unique = self.lookup_unique(states, inputs)
        retrieved = self.retrieve_unique(unique, step)
        return self.pool_features(retrieved, inputs), unique

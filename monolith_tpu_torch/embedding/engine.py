"""The embedding engine: host id mapping + device row pools, end to end.

The port's single-shard fused path of the JAX package's engine. Each step:

  host (C++):  per table: concat feature fid streams -> dedup ->
               HostStore map -> pack one int32 wire  (prepare_wire; a
               table whose unique cap is above 65535 carries int32 index
               words, the others packed 16-bit pairs)
  device:      decode_wire -> gather the unique packed rows (K1) with
               new-row init as a select (fused_lookup) -> per-feature
               gather + pool (pool_features) -> model fwd/bwd -> per-segment
               row optimize -> [bf16 pools: narrow, stochastically by K3]
               -> ONE scatter per table (K2, fused_apply)

A training step reaches the engine through its step entry points alone:
`step_words`, `pack_step` (with `revive_of`), `decode_step`,
`attach_revive`, `lookup_step` and `apply_step`. They are the one place
that knows the step's wire format (the 16-bit wire, a wide table's int32
index words, the multi-array path's int32 arrays) and the table layout
(packed pools or the structure-of-arrays state): each picks its path from
`packed`, `wire_capable`, `config.tiered` and `wide`, so the trainer's
wire and step branch on none of them.

Autograd through the per-feature gather produces the per-unique-row summed
gradients (an index-add into the unique buffer). Per-step shapes are fixed:
`unique_cap` unique ids per table, -1 padded; overflow ids read zeros and
receive no update.

The 1-step-stale asynchronous block (EngineConfig.async_optimize, driven by
training/trainer.py) splits fused_apply in two: `optimize_rows` (row math
only, on freshly gathered rows, with the rows the forward used handed to DC
segments) and `scatter_rows` (the deferred write-back, one K2 per table, a
step later).

The multi-array path (`fuse_wire` False: the JAX package's other step
path) takes what the wire does not carry: `compact_wire=False` and the
structure-of-arrays state of `packed="off"` (table.py). The JAX package
also sends unique caps above 65535 there; the port's wire carries them as
a wide table (int32 index words, one a position), so that such a model
runs blocks and the stage worker. Its host side is `prepare_batch`
(dedup and the id map in Python over the same C++), whose arrays
`pack_arrays` lays into int32 words and `decode_arrays` reads back on the
device. A packed engine then
steps with fused_lookup / fused_apply as on the wire; a
structure-of-arrays engine with `admit_rows` (init of the new rows and the
revive, one `index_copy_` an array), `lookup_unique` (`index_select`) and
`apply_gradients` (per-array update, K3 on a bf16 table's params).

Expiry (a table with `eviction.ttl_seconds > 0`): `evict_expired` frees
the rows of ids not updated since a timestamp in the host stores, and
`zero_rows` zeroes those rows on the device (params and slots; one K2
launch a packed table), so that no evicted state survives into a recycled
row.

Tiered storage (`EngineConfig.tiered`): expired rows spill to a host
archive a table (embedding/tiered.py, driven by Trainer.spill_expired) and
come back when their id is admitted again. That takes the host path of
`prepare_batch`, which runs dedup, the id map and the archive's revive in
Python over the same C++ and returns the step's arrays; `pack_wire` packs
them into the wire `prepare_wire` writes, byte for byte, and the revived
rows travel beside it: only the n revived rows, padded to a power of two
with position -1. `fused_lookup` lays them over the gathered rows (a
structure-of-arrays engine's `admit_rows` writes them with
restore_packed_rows). As in the JAX package, a tiered single-device
trainer steps one by one (no blocks); the sharded trainers take each
step's revived rows at its pack and run blocks.

Sharded tables (`num_shards = S > 1`, one rank a shard): the engine's
device functions serve shard `self.shard`, which keys their new-row init
and K3 draws apart from the other shards'. Under parallel/sharded.py every
rank holds all S host stores and runs the same host prepare over the whole
global batch, as the JAX package's one host engine does for its S devices:
`prepare_shards` (allgather exchange) and `prepare_batch_a2a` (bucketed
all-to-all) return the JAX package's arrays with their leading shard axis.
A tiered engine holds an archive for each shard it serves: every shard's
when built without a `shard`, as the JAX package's one host engine does,
and only its own when the caller names its shard (a sharded trainer's
rank: one archive holds 4x a shard's rows, so a rank cannot keep S of
them); the other shards' archives are None and their revives are left to
the ranks that hold them. With `local_shards` (the multi-host trainer,
parallel/multihost.py) the engine holds the host stores, and when tiered
the archives, of those shards only (None for the others) and `shard` is
the first of them; the trainer then maps ids in its own store. The
sharded steps do not take the wire, so their caps are not held to its
rules. No path takes a unique cap above 2**31 - 1 (int32 indices).
`stores` and `archives` are the single-shard views (empty when S > 1);
`store_of` / `archive_of` give the engine's own shard's at any S.

Decoded inputs and table states carry no shard axis (the JAX package's
carry a leading one). Table states are updated in place by fused_apply,
scatter_rows, admit_rows, apply_gradients and zero_rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from monolith_tpu_torch.device import resolve_device
from monolith_tpu_torch.embedding import host_store
from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.embedding.host_store import (Batcher, Batcher2D,
                                                      FilterKind, HostStore)
from monolith_tpu_torch.embedding.spec import TableSpec
from monolith_tpu_torch.embedding.tiered import RowArchive, state_width
from monolith_tpu_torch.feature import FeatureConfig, combine
from monolith_tpu_torch.ops.scatter import scatter_rows

_FILTER_KINDS = {
    "none": FilterKind.NONE,
    "sliding": FilterKind.SLIDING,
    "probabilistic": FilterKind.PROBABILISTIC,
    "probabilistic_unequal": FilterKind.PROBABILISTIC_UNEQUAL,
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_shards: int = 1      # table shards: one per rank (parallel/sharded.py)
    unique_cap: int = 4096   # unique ids per table shard per step
    new_cap: int = 1024      # admissions per table shard per step
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
    # two-tier storage: expired rows spill their full state to a host
    # archive and revive on re-admission (Trainer.spill_expired)
    tiered: bool = False
    archive_capacity: int = 0  # rows an archive holds; 0 = 4x the table's
    # the sharded trainer's embedding exchange: "allgather" sends every
    # shard's unique rows to every rank (S*U rows each way a step); "a2a"
    # sends each rank only the rows its batch slice reads, in buckets of
    # `effective_bucket_cap` rows a (table shard, batch shard) pair; ids
    # that overflow a bucket read zeros and are counted as overflow
    exchange: str = "allgather"
    bucket_cap: int = 0      # 0 = max(128, 2 * unique_cap / num_shards)
    # the shards whose host stores (and archives) this process holds
    # (None = all); the multi-host trainer holds only its own rank's
    local_shards: Optional[Tuple[int, ...]] = None
    # 16-bit index matrices and new-row positions where they fit (the
    # JAX package's compact wire); False ships int32 index matrices and
    # new-row row ids instead, on the multi-array path
    compact_wire: bool = True
    # "auto": one packed pool a table when every table is f32 or bf16;
    # "off": the structure-of-arrays state (params in the table's dtype,
    # f32 optimizer slots), stepped on the multi-array path
    packed: str = "auto"

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

    @property
    def effective_bucket_cap(self) -> int:
        if self.bucket_cap > 0:
            return self.bucket_cap
        return max(128, 2 * self.unique_cap // max(self.num_shards, 1))

    @property
    def index_dtype(self):
        """dtype of prepare_shards' index matrices (values < S * U): 16-bit
        where they fit and compact_wire is on, as the JAX package's."""
        return _index_dtype(self.compact_wire, self.num_shards,
                            self.unique_cap)

    @property
    def pos_dtype(self):
        """dtype of positions into one shard's unique list (< U)."""
        return _index_dtype(self.compact_wire, 1, self.unique_cap)


#: the largest unique cap whose wire indices travel as 16-bit words (they
#: decode unsigned, with 0xFFFF the invalid sentinel); a table above it
#: carries int32 index words (a wide table)
NARROW_CAP = 65535
#: the largest unique cap of any path: indices are int32
MAX_CAP = 2 ** 31 - 1


def _index_dtype(compact: bool, shards: int, cap: int):
    """int16 for values below shards * cap when that is <= 32768 and the
    compact wire is on; int32 otherwise (the JAX package's rule)."""
    return np.int16 if compact and shards * cap <= 32768 else np.int32


# Three seed domains, one for each stream of random numbers of a step, told
# apart by the top two bits of the 64-bit seed so that no two can collide:
#
#   bit 63 = 0          new-row init         (JAX: the trainer's base key)
#   bits 63, 62 = 1, 0  fused_apply's K3     (JAX: PRNGKey(1))
#   bits 63, 62 = 1, 1  scatter_rows' K3     (JAX: PRNGKey(2))
#
# Below the domain bits each is the same mix of (seed, step, table index),
# as the JAX package folds step and table index into each of its keys; a
# table shard s > 0 (the sharded trainer's rank) XORs in s times an odd
# 64-bit constant, as the JAX package folds in the device's index; shard 0
# keeps the single-shard seeds.

def _seed_mix(seed: int, step: int, table_index: int, shard: int = 0) -> int:
    mix = (seed * 1_000_003 + step) * 1_009 + table_index
    return mix ^ (shard * 0x9E3779B97F4A7C15) % (1 << 64)


def _init_seed(seed: int, step: int, table_index: int, shard: int = 0) -> int:
    """Philox seed of one table shard's new-row init at one step."""
    return _seed_mix(seed, step, table_index, shard) % (1 << 63)


def _round_seed(seed: int, step: int, table_index: int,
                shard: int = 0) -> int:
    """Philox key of one table shard's stochastic bf16 write-back (K3) in
    fused_apply at one step."""
    return _seed_mix(seed, step, table_index, shard) % (1 << 62) | (1 << 63)


def _defer_seed(seed: int, step: int, table_index: int,
                shard: int = 0) -> int:
    """Philox key of one table shard's stochastic bf16 write-back (K3) in
    scatter_rows, the asynchronous block's deferred write-back."""
    return _seed_mix(seed, step, table_index, shard) % (1 << 62) | (3 << 62)


def pad_rows(rows: np.ndarray) -> np.ndarray:
    """`rows` as int32, padded with -1 to the next power of two: K1 and K2
    drop -1 rows, and the launch lengths of an eviction, a spill or a
    revive stay O(log capacity) in number."""
    out = np.full(1 << (len(rows) - 1).bit_length(), -1, np.int32)
    out[:len(rows)] = rows
    return out


def _overlay_revived(p: torch.Tensor, pos: torch.Tensor,
                     values: torch.Tensor) -> None:
    """p[pos[i], :width] = values[i], p[pos[i], width:] = 0 in place, for
    the entries with pos >= 0 (an index_copy_, plain PyTorch as the JAX
    package's is plain XLA). The -1 entries form the tail after at least
    one valid entry; each writes entry 0's position and row again, so every
    write to a position carries the same row and their order cannot matter,
    and nothing waits for the device to count the valid entries."""
    keep = pos >= 0
    idx = torch.where(keep, pos, pos[:1]).long()
    full = torch.zeros((pos.shape[0], p.shape[1]), dtype=p.dtype,
                       device=p.device)
    full[:, :values.shape[1]] = torch.where(keep[:, None], values, values[:1])
    p.index_copy_(0, idx, full)


class EmbeddingEngine:
    """Owns host state (stores/batchers) and the device-side functions."""

    def __init__(self, tables: Sequence[TableSpec],
                 features: Sequence[FeatureConfig],
                 config: EngineConfig = EngineConfig(),
                 seed: int = 0, device=None, shard: Optional[int] = None):
        S = config.num_shards
        if S < 1:
            raise ValueError(f"num_shards must be >= 1 (got {S})")
        if shard is not None and not 0 <= shard < S:
            raise ValueError(f"shard {shard} is not a shard of 0..{S - 1}")
        if config.exchange not in ("allgather", "a2a"):
            raise ValueError(f"exchange must be 'allgather' or 'a2a' (got "
                             f"{config.exchange!r})")
        local = (None if config.local_shards is None
                 else sorted(set(config.local_shards)))
        if local is not None and (not local or local[0] < 0
                                  or local[-1] >= S):
            raise ValueError(f"local_shards {config.local_shards} must be "
                             f"shards of 0..{S - 1}")
        if S > 1 and (config.unique_caps or config.new_caps):
            raise ValueError("per-table unique_caps/new_caps require "
                             "num_shards == 1 (sharded paths use the "
                             "global caps)")
        if config.max_ucap > MAX_CAP:
            raise ValueError(f"unique caps above 2**31 - 1 ({MAX_CAP}) have "
                             f"no int32 index (got {config.max_ucap})")
        if config.packed not in ("auto", "off"):
            raise ValueError(f"packed must be 'auto' or 'off' (got "
                             f"{config.packed!r})")
        self.config = config
        self.device = resolve_device(device)
        self.tables: Dict[str, TableSpec] = {t.name: t for t in tables}
        self.features: Dict[str, FeatureConfig] = {f.name: f for f in features}
        for f in features:
            if f.table not in self.tables:
                raise ValueError(f"feature {f.name} references unknown table {f.table}")
        self.table_features: Dict[str, List[FeatureConfig]] = {
            t: [f for f in features if f.table == t] for t in self.tables}
        # one host store a table shard, seeded as the JAX package seeds
        # shard s's (None for a shard outside local_shards); `stores` is
        # the single-shard view, left empty when S > 1 so that no consumer
        # reads one shard of several by mistake
        self.shard_stores: Dict[str, List[Optional[HostStore]]] = {}
        self.batchers: Dict[str, Batcher] = {}
        self.batchers2d: Dict[str, Batcher2D] = {}
        for name, t in self.tables.items():
            self.shard_stores[name] = [
                HostStore(row_capacity=t.capacity_per_shard,
                          filter_kind=_FILTER_KINDS[t.admission.kind],
                          admit_threshold=t.admission.threshold,
                          filter_capacity=t.admission.filter_capacity,
                          filter_splits=t.admission.filter_splits,
                          seed=seed * 1000003 + s)
                if local is None or s in local else None
                for s in range(S)]
            self.batchers[name] = Batcher(expected_unique=config.ucap(name) * S)
            self.batchers2d[name] = Batcher2D(
                expected_unique=config.ucap(name) * S)
        self.stores: Dict[str, HostStore] = (
            {name: st[0] for name, st in self.shard_stores.items()}
            if S == 1 else {})
        # the table shard the device functions serve: the first held one,
        # or the caller's (a sharded trainer's rank)
        self.shard = local[0] if local else (shard or 0)
        # a tiered table's archive a served shard (local_shards', the
        # caller's shard alone, or all), seeded with seed + s as the JAX
        # package seeds shard s's
        served = (local if local is not None
                  else None if shard is None else [shard])
        self.shard_archives: Dict[str, List[Optional[RowArchive]]] = (
            {name: [RowArchive(t, config.archive_capacity
                               or 4 * t.capacity_per_shard, seed=seed + s)
                    if served is None or s in served else None
                    for s in range(S)]
             for name, t in self.tables.items()} if config.tiered else {})
        self.archives: Dict[str, RowArchive] = (
            {name: a[0] for name, a in self.shard_archives.items()}
            if S == 1 else {})
        self._generator = torch.Generator(device=self.device)
        # one packed pool a table, or the structure-of-arrays state
        self.packed = (config.packed != "off"
                       and all(table_lib.is_packed(t) for t in tables))

    @property
    def wire_capable(self) -> bool:
        """Whether a step's engine inputs fit the wire: packed tables,
        compact_wire and one shard. A table's indices travel as 16-bit
        words up to a unique cap of NARROW_CAP (decoded unsigned, 0xFFFF
        the invalid sentinel, so a larger cap would alias rows) and as
        int32 words above it (`wide`)."""
        cfg = self.config
        return self.packed and cfg.compact_wire and cfg.num_shards == 1

    def wide(self, tname: str) -> bool:
        """Whether a table's wire index words are int32 (its unique cap is
        above NARROW_CAP) rather than packed 16-bit pairs."""
        return self.config.ucap(tname) > NARROW_CAP

    def _width(self, tname: str) -> int:
        """A table's `host_store.prepare_wire_multi` width. A wide table's
        ids are mapped as `prepare_batch` maps them (the JAX package's
        path for such caps): with each id's occurrences in the step where
        the table has admission, else counted once a step."""
        if not self.wide(tname):
            return host_store.NARROW
        if self.tables[tname].admission.kind != "none":
            return host_store.WIDE_COUNTED
        return host_store.WIDE

    def _index_words(self, tname: str, n: int) -> int:
        """Wire words of a feature's n index entries in table `tname`."""
        return n if self.wide(tname) else (n + 1) // 2

    @property
    def fuse_wire(self) -> bool:
        """The JAX package's switch between its two step paths: the one
        fused wire (True) or the multi-array path. The wire also needs an
        engine that is not tiered; the port's tiered trainer still steps
        through the wire whenever `wire_capable`, with its revived rows
        beside it."""
        return self.wire_capable and not self.config.tiered

    def store_of(self, tname: str) -> HostStore:
        """The host store of this engine's own shard (`self.shard`)."""
        return self.shard_stores[tname][self.shard]

    def archive_of(self, tname: str) -> RowArchive:
        """The archive of this engine's own shard (a tiered engine)."""
        return self.shard_archives[tname][self.shard]

    # ------------------------------------------------------------------
    # a training step's entry points: each picks the wire format and the
    # table layout's path itself
    # ------------------------------------------------------------------

    def step_words(self, batch_size: int) -> int:
        """Words of the engine's region of a step's wire: the 16-bit wire
        (`wire_capable`) or the multi-array path's int32 arrays."""
        if self.wire_capable:
            return self.wire_words(batch_size)
        return self.array_words(batch_size)

    def pack_step(self, fid_batch: Dict[str, np.ndarray], ts: int,
                  out: np.ndarray) -> Tuple[Dict, Optional[Dict]]:
        """A step's host prepare into its engine region `out`
        ([step_words(B)] int32): `prepare_wire` on the fused wire, else
        `prepare_batch` packed by `pack_wire` or `pack_arrays`. Returns
        (stats, revive): revive as `revive_of` gives it."""
        if self.fuse_wire:
            _, stats = self.prepare_wire(fid_batch, ts=ts, out=out)
            return stats, None
        inputs, stats = self.prepare_batch(fid_batch, ts=ts)
        if self.wire_capable:
            out[:] = self.pack_wire(inputs)
        else:
            self.pack_arrays(inputs, out)
        return stats, self.revive_of(inputs)

    def revive_of(self, inputs: Dict, shard: Optional[int] = None
                  ) -> Optional[Dict]:
        """A tiered engine's revived rows of prepared inputs (row `shard`
        of a sharded engine's), {table: (positions or rows, values)}, which
        travel beside the wire; None when not tiered."""
        if not self.config.tiered:
            return None
        key = self._revive_key()
        if shard is None:
            return {t: (tin[key], tin["revive_values"])
                    for t, tin in inputs.items()}
        return {t: (tin[key][shard], tin["revive_values"][shard])
                for t, tin in inputs.items()}

    def _revive_key(self) -> str:
        """Where this layout's revived rows go: positions into the step's
        rows (packed) or the rows themselves (structure of arrays)."""
        return "revive_pos" if self.packed else "revive_rows"

    def attach_revive(self, inputs: Dict, uploaded: Dict) -> None:
        """Lay a step's uploaded revived rows ({table: (positions or rows,
        values)} on the device) into its decoded inputs."""
        key = self._revive_key()
        for tname, (pos, values) in uploaded.items():
            inputs[tname][key] = pos
            inputs[tname]["revive_values"] = values

    def decode_step(self, words: torch.Tensor, batch_size: int) -> Dict:
        """Device side of `pack_step`: `decode_wire` or `decode_arrays`."""
        if self.wire_capable:
            return self.decode_wire(words, batch_size)
        return self.decode_arrays(words, batch_size)

    def lookup_step(self, states: Dict, inputs: Dict, seed: int, step: int
                    ) -> Tuple[Optional[Dict], Dict[str, torch.Tensor]]:
        """A synchronous step's rows: (held, unique {table: [U, dim]}).
        Packed: `fused_lookup` (held: the gathered packed rows). Structure
        of arrays: `admit_rows` (the new rows initialised, and revived,
        before the forward reads them), then `lookup_unique` (held:
        None)."""
        if self.packed:
            return self.fused_lookup(states, inputs, seed, step)
        self.admit_rows(states, inputs, seed, step)
        return None, self.lookup_unique(states, inputs)

    @torch.no_grad()
    def apply_step(self, states: Dict, inputs: Dict, held: Optional[Dict],
                   unique_grads: Dict[str, torch.Tensor], step: int,
                   seed: int = 0) -> Dict:
        """A synchronous step's row update, in place: `fused_apply` of the
        rows `lookup_step` held, or `apply_gradients`."""
        if self.packed:
            return self.fused_apply(states, inputs, held, unique_grads, step,
                                    seed=seed)
        return self.apply_gradients(states, inputs, unique_grads, step,
                                    seed=seed)

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
                      + sum(self._index_words(tname, batch_size * f.max_length)
                            for f in feats))
        return total

    def prepare_wire(self, fid_batch: Dict[str, np.ndarray], ts: int,
                     out: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, Dict]:
        """Fused host prepare: ONE native call runs dedup + store map + wire
        pack for ALL tables. Layout per table (sorted name order):

          [ucap(table) words]  row | (new << 30); -1 for invalid rows
          per feature (declared order): ceil(B*L/2) words of 16-bit indices,
            or, in a wide table (`wide`), B*L int32 words (-1 invalid)

        Bit-identical to the JAX package's wire for the same store state and
        batch where no table is wide (the JAX package has no wide table).
        Pass `out` (contiguous int32, exactly the engine wire length) to
        write into a larger caller-owned transfer buffer."""
        cfg = self.config
        if cfg.num_shards != 1:
            raise ValueError("prepare_wire packs one shard's wire; a sharded "
                             "engine prepares with prepare_shards or "
                             "prepare_batch_a2a")
        if not cfg.compact_wire or not self.packed:
            raise ValueError(
                f"prepare_wire requires packed tables and compact_wire (got "
                f"packed={self.packed}, compact_wire={cfg.compact_wire}); "
                f"use prepare_batch (the multi-array path)")
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
                           + sum(self._index_words(tname, s.size)
                                 for s in streams))
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
            cfg.record_touch, wire, offsets,
            widths=[self._width(t) for t in names])
        stats = {"overflow": {}, "new": {}, "unique": {}, "filtered": {},
                 "new_rejected": {}}
        for i, tname in enumerate(names):
            stats["overflow"][tname] = int(st[i, 0])
            stats["new"][tname] = int(st[i, 1])
            stats["unique"][tname] = int(st[i, 2])
            stats["filtered"][tname] = int(st[i, 3])
            stats["new_rejected"][tname] = int(st[i, 4])
        return wire, stats

    def prepare_batch(self, fid_batch: Dict[str, np.ndarray], ts: int
                      ) -> Tuple[Dict, Dict]:
        """The host path of a step's inputs, in Python over the same C++ as
        prepare_wire: per table, dedup (with each id's occurrences when the
        table has admission), the id map and, when tiered, the archive's
        revive of newly admitted ids. Returns (inputs, stats). A sharded
        engine's inputs are prepare_shards'. A single-shard engine's carry
        no shard axis; per table:

          {"rows": [U] int32 (-1 invalid),
           one new-row channel, as the JAX package's:
             "new_mask": [U] uint8              (packed tables)
             "new_pos":  [K] positions into rows, -1 padded, int16 when
                         compact_wire and U <= 32768 (structure of arrays)
             "new_rows": [K] int32 rows, -1 padded (structure of arrays
                         without compact_wire),
           "index": {feature: [B, L] int32 (-1 invalid)}}

        and when tiered "revive_pos" (packed) or "revive_rows" (structure
        of arrays) [m] int32 and "revive_values" [m, state_width] f32: the
        n revived ids, padded to m = the next power of two with -1 (m = 0
        when none). The JAX package ships [S, new_cap] and [S, new_cap,
        width] with -1 tails; the values are the same. `pack_wire` turns a
        packed engine's arrays into prepare_wire's bytes, `pack_arrays`
        any engine's into the multi-array path's words."""
        inputs, stats = self.prepare_shards(fid_batch, ts)
        if self.config.num_shards == 1:
            for tin in inputs.values():
                for k in ("rows", "new_mask", "new_pos", "new_rows",
                          "revive_pos", "revive_rows", "revive_values"):
                    if k in tin:
                        tin[k] = tin[k][0]
                tin["index"] = {f: i.astype(np.int32)
                                for f, i in tin["index"].items()}
        return inputs, stats

    def _new_channels(self, tname: str, S: int) -> Dict:
        """A table's rows [S, U] and its empty new-row channel (new_mask,
        new_pos or new_rows, as prepare_batch describes them)."""
        cfg = self.config
        U, K = cfg.ucap(tname), cfg.ncap(tname)
        tin = {"rows": np.full((S, U), -1, dtype=np.int32)}
        if self.packed:
            tin["new_mask"] = np.zeros((S, U), dtype=np.uint8)
        elif cfg.compact_wire:
            tin["new_pos"] = np.full((S, K), -1,
                                     dtype=_index_dtype(True, 1, U))
        else:
            tin["new_rows"] = np.full((S, K), -1, dtype=np.int32)
        return tin

    def prepare_shards(self, fid_batch: Dict[str, np.ndarray], ts: int
                       ) -> Tuple[Dict, Dict]:
        """The JAX package's prepare_batch, array for array: per table

          {"rows": [S, U] int32 (-1 invalid), the new-row channel [S, U]
           or [S, K] (prepare_batch's),
           "index": {feature: [B, L] into the flat [S*U] buffer of every
                     shard's unique rows, -1 invalid; int16 when
                     compact_wire and S*U <= 32768, else int32}}

        and, tiered, "revive_pos" (packed) or "revive_rows" (structure of
        arrays) [S, m] int32 and "revive_values" [S, m, state_width] f32:
        shard s's revived ids from its archive, -1 padded to m = the next
        power of two of the most any shard revived (m = 0 when none); a
        shard whose archive the engine does not hold revives nothing here.
        Ids route to shards by `shard_of`; each shard's host store maps its
        own."""
        cfg = self.config
        S = cfg.num_shards
        if cfg.local_shards is not None:
            raise ValueError("an engine that holds only its local shards' "
                             "stores maps ids through the multi-host "
                             "trainer (parallel.MultiHostTrainer)")
        inputs = {}
        stats = {"overflow": {}, "new": {}, "unique": {}, "filtered": {},
                 "new_rejected": {}}
        for tname, feats in self.table_features.items():
            if not feats:
                continue
            U, K = cfg.ucap(tname), cfg.ncap(tname)
            streams = [np.ascontiguousarray(fid_batch[f.name], dtype=np.int64)
                       for f in feats]
            flat = np.concatenate([s.ravel() for s in streams])
            occ = None
            if self.tables[tname].admission.kind != "none":
                unique, index, counts, occ, overflow = \
                    self.batchers[tname].dedup_counts(flat, S, U)
            else:
                unique, index, counts, overflow = self.batchers[tname].dedup(
                    flat, S, U)
            tin = self._new_channels(tname, S)
            n_new, n_rej, n_filtered = self._map_shards(
                tname, unique, counts, occ, ts, K, tin)
            idt = _index_dtype(cfg.compact_wire, S, U)
            tin["index"] = {}
            off = 0
            for f, stream in zip(feats, streams):
                tin["index"][f.name] = index[off:off + stream.size].reshape(
                    stream.shape).astype(idt, copy=False)
                off += stream.size
            inputs[tname] = tin
            stats["overflow"][tname] = overflow
            stats["new"][tname] = n_new
            stats["unique"][tname] = int(counts.sum())
            stats["filtered"][tname] = n_filtered
            stats["new_rejected"][tname] = n_rej
        return inputs, stats

    def _map_shards(self, tname: str, unique: np.ndarray, counts: np.ndarray,
                    occ: Optional[np.ndarray], ts: int, K: int, tin: Dict
                    ) -> Tuple[int, int, int]:
        """Map each shard's unique ids in its host store into tin["rows"]
        [S, U] and the new-row channel; a tiered table's revives, from the
        archives the engine holds, into tin["revive_pos"] (or
        ["revive_rows"]) / ["revive_values"] (prepare_shards' [S, m]). As
        in the JAX package, `map_train` maps where neither positions nor
        occurrence counts are wanted (structure of arrays, no compact wire,
        no admission), `map_train_pos` elsewhere. Returns (new,
        budget-rejected, admission-filtered) summed over the shards."""
        cfg = self.config
        use_pos = self.packed or cfg.compact_wire or occ is not None
        n_new = n_rej = n_filtered = 0
        revived = {}
        for s, store in enumerate(self.shard_stores[tname]):
            c = int(counts[s])
            if c == 0:
                continue
            if use_pos:
                r, nr, nf, npos = store.map_train_pos(
                    unique[s, :c], ts=ts, new_cap=K,
                    record_touch=cfg.record_touch,
                    counts=None if occ is None else occ[s, :c])
            else:
                r, nr, nf = store.map_train(unique[s, :c], ts=ts, new_cap=K,
                                            record_touch=cfg.record_touch)
            if "new_mask" in tin:
                tin["new_mask"][s, npos] = 1
            elif "new_pos" in tin:
                tin["new_pos"][s, :len(npos)] = npos
            else:
                tin["new_rows"][s, :len(nr)] = nr
            tin["rows"][s, :c] = r
            n_new += len(nr)
            n_rej += store.last_rejected
            # -1 rows are admission-filtered or budget-rejected ids; the
            # rejected ones are counted in new_rejected already
            n_filtered += int((r == -1).sum()) - store.last_rejected
            archive = (self.shard_archives[tname][s] if cfg.tiered
                       else None)
            if archive is not None and len(nf):
                ok, vals = archive.revive(nf)
                if ok.any():
                    revived[s] = ((npos if self.packed else nr)[ok], vals[ok])
        if cfg.tiered:
            n = max((len(p) for p, _ in revived.values()), default=0)
            m = 1 << (n - 1).bit_length() if n else 0
            pos = np.full((len(counts), m), -1, np.int32)
            values = np.zeros((len(counts), m,
                               state_width(self.tables[tname])), np.float32)
            for s, (p, v) in revived.items():
                pos[s, :len(p)], values[s, :len(p)] = p, v
            tin["revive_pos" if self.packed else "revive_rows"] = pos
            tin["revive_values"] = values
        return n_new, n_rej, n_filtered

    def prepare_batch_a2a(self, fid_batch: Dict[str, np.ndarray], ts: int
                          ) -> Tuple[Dict, Dict]:
        """The bucketed all-to-all's host prepare, the JAX package's
        prepare_batch_a2a array for array. Per table:

          {"rows": [S, U] int32, the new-row channel (prepare_batch's),
           "bucket_idx": [S, D, cap] (pos_dtype): for table shard s and
                         batch shard d, positions into shard s's unique
                         list of the rows batch shard d reads, -1 padded,
           "index": {feature: [B, L] into batch shard d's receive buffer
                     [S*cap] (rows d*B/D .. (d+1)*B/D), -1 invalid or
                     overflowed; int16 when compact_wire and
                     S*cap <= 32768, else int32}}

        and a tiered table's revives, as prepare_shards', with D = S batch
        shards (the batch must divide by S) and cap =
        effective_bucket_cap; stats as prepare_batch's without
        "filtered"."""
        cfg = self.config
        if cfg.local_shards is not None:
            raise ValueError("prepare_batch_a2a: an engine that holds only "
                             "its local shards' stores maps ids through the "
                             "multi-host trainer")
        S, U, K = cfg.num_shards, cfg.unique_cap, cfg.new_cap
        D = S
        cap = cfg.effective_bucket_cap
        inputs = {}
        stats = {"overflow": {}, "new": {}, "unique": {}, "new_rejected": {}}
        for tname, feats in self.table_features.items():
            if not feats:
                continue
            streams = [np.ascontiguousarray(fid_batch[f.name], dtype=np.int64)
                       for f in feats]
            B = streams[0].shape[0]
            if B % D:
                raise ValueError(f"batch {B} does not divide into {D} shards")
            rows_per = B // D
            # batch-shard-major: for each batch shard, every feature's fids
            flat = np.concatenate(
                [st[d * rows_per:(d + 1) * rows_per].ravel()
                 for d in range(D) for st in streams])
            occ = None
            if self.tables[tname].admission.kind != "none":
                (unique, counts, bucket_idx, _, index, occ,
                 overflow) = self.batchers2d[tname].dedup2(
                    flat, num_batch_shards=D, num_shards=S, global_cap=U,
                    bucket_cap=cap)
            else:
                unique, counts, bucket_idx, _, index, overflow = \
                    self.batchers2d[tname].dedup(
                        flat, num_batch_shards=D, num_shards=S,
                        global_cap=U, bucket_cap=cap)
            tin = self._new_channels(tname, S)
            n_new, n_rej, _ = self._map_shards(tname, unique, counts, occ,
                                               ts, K, tin)
            idt = _index_dtype(cfg.compact_wire, S, cap)
            tin["index"] = {f.name: np.empty(st.shape, dtype=idt)
                            for f, st in zip(feats, streams)}
            pos = 0
            for d in range(D):
                for f, st in zip(feats, streams):
                    n = rows_per * st.shape[1]
                    tin["index"][f.name][d * rows_per:(d + 1) * rows_per] = \
                        index[pos:pos + n].reshape(rows_per, st.shape[1])
                    pos += n
            tin["bucket_idx"] = bucket_idx.astype(cfg.pos_dtype, copy=False)
            inputs[tname] = tin
            stats["overflow"][tname] = overflow
            stats["new"][tname] = n_new
            stats["unique"][tname] = int(counts.sum())
            stats["new_rejected"][tname] = n_rej
        return inputs, stats

    def pack_wire(self, inputs: Dict) -> np.ndarray:
        """prepare_batch's arrays as the int32 wire that prepare_wire writes
        (layout in its docstring), byte for byte. Indices travel as 16-bit
        words, decoded unsigned: values up to 65534 keep their bits; a
        wide table's as int32 words."""
        parts = []
        for tname in sorted(inputs):
            tin = inputs[tname]
            rows = np.array(tin["rows"], dtype=np.int32)
            np.bitwise_or(rows, np.int32(1 << 30), out=rows,
                          where=tin["new_mask"].astype(bool))
            parts.append(rows)
            for f in self.table_features[tname]:
                if self.wide(tname):
                    parts.append(np.asarray(tin["index"][f.name],
                                            np.int32).ravel())
                    continue
                idx = np.asarray(tin["index"][f.name]).astype(np.int16).ravel()
                if idx.size % 2:
                    idx = np.concatenate([idx, np.full(1, -1, np.int16)])
                parts.append(idx.view(np.int32))
        return np.concatenate(parts)

    def array_words(self, batch_size: int) -> int:
        """Number of int32 words of the multi-array path's engine region
        for a batch (layout in pack_arrays)."""
        cfg = self.config
        total = 0
        for tname, feats in self.table_features.items():
            if not feats:
                continue
            total += (cfg.ucap(tname)
                      + (0 if self.packed else cfg.ncap(tname))
                      + sum(batch_size * f.max_length for f in feats))
        return total

    def pack_arrays(self, inputs: Dict, out: np.ndarray) -> None:
        """prepare_batch's arrays into the multi-array path's int32 region
        `out` ([array_words(B)]), per table in sorted name order:

          [U]       rows; a packed table's with its new-row mask in bit 30
                    (as the wire's), -1 rows stay -1
          [K]       a structure-of-arrays table's new_pos or new_rows,
                    widened to int32
          [B*L]     per feature (declared order): the index matrix, int32

        Every array travels as full int32 words, so unique caps above
        65535 address their rows."""
        off = 0

        def put(a):
            nonlocal off
            out[off:off + a.size] = a.ravel()
            off += a.size

        for tname in sorted(inputs):
            tin = inputs[tname]
            if "new_mask" in tin:
                rows = np.array(tin["rows"], dtype=np.int32)
                np.bitwise_or(rows, np.int32(1 << 30), out=rows,
                              where=tin["new_mask"].astype(bool))
                put(rows)
            else:
                put(tin["rows"])
                put(tin["new_pos" if "new_pos" in tin else "new_rows"])
            for f in self.table_features[tname]:
                put(np.asarray(tin["index"][f.name]))
        if off != out.size:
            raise ValueError(f"engine region of {out.size} words, "
                             f"{off} packed")

    def decode_arrays(self, words: torch.Tensor, batch_size: int) -> Dict:
        """Device-side inverse of pack_arrays. Returns per table
        {"rows": [U] int32, "new_mask": [U] uint8 (packed) or "new_pos" /
        "new_rows": [K] int32 (structure of arrays), "index": {feature:
        [B, L] int32}}, views of `words` where no decode is needed."""
        cfg = self.config
        inputs = {}
        off = 0

        def take(n):
            nonlocal off
            off += n
            return words[off - n:off]

        for tname in sorted(self.table_features):
            feats = self.table_features[tname]
            if not feats:
                continue
            rows = take(cfg.ucap(tname))
            if self.packed:
                invalid = rows < 0
                tin = {"new_mask": torch.where(invalid, 0, (rows >> 30) & 1
                                               ).to(torch.uint8),
                       "rows": torch.where(invalid, -1,
                                           rows & ((1 << 30) - 1))}
            else:
                tin = {"rows": rows,
                       "new_pos" if cfg.compact_wire else "new_rows":
                       take(cfg.ncap(tname))}
            tin["index"] = {f.name: take(batch_size * f.max_length).reshape(
                batch_size, f.max_length) for f in feats}
            inputs[tname] = tin
        return inputs

    def evict_expired(self, expire_before: int) -> Dict[str, np.ndarray]:
        """Expiry on the host stores of every table with a ttl: ids whose
        last update is older than `expire_before` leave the id map. Returns
        the freed rows {table: int64 [n]}, for zero_rows; shard s's rows
        read s * capacity_per_shard + row. Only the held shards' stores
        (local_shards) evict."""
        out = {}
        for tname, t in self.tables.items():
            if t.eviction.ttl_seconds <= 0:
                continue
            # shard s's rows as s * capacity + row, as the JAX package's
            out[tname] = np.concatenate(
                [np.empty(0, np.int64)]
                + [st.evict_expired(expire_before).astype(np.int64)
                   + s * t.capacity_per_shard
                   for s, st in enumerate(self.shard_stores[tname])
                   if st is not None])
        return out

    @torch.no_grad()
    def zero_rows(self, states: Dict, freed: Dict[str, np.ndarray]) -> Dict:
        """Zero freed rows of the device state in place, params and every
        optimizer slot, so that no evicted state survives into a recycled
        row. A packed pool takes one K2 launch a table of zero rows in its
        own dtype (a bf16 pool gets bf16 zeros, exact, with no K3); a
        structure-of-arrays state one `index_copy_` an array. The row list
        is padded by `pad_rows`."""
        for tname, rows in freed.items():
            if rows.size == 0:
                continue
            idx = torch.from_numpy(pad_rows(rows)).to(self.device)
            state = states[tname]
            if "data" not in state:
                table_lib.zero_rows(state, idx)
                continue
            pool = state["data"]
            scatter_rows(pool, idx, torch.zeros((len(idx), pool.shape[1]),
                                                dtype=pool.dtype,
                                                device=pool.device))
        return states

    # ------------------------------------------------------------------
    # device side
    # ------------------------------------------------------------------

    def create_states(self) -> Dict[str, table_lib.TableState]:
        """One state per table on the engine's device: a packed pool, or
        the structure-of-arrays state when `self.packed` is False."""
        return {name: table_lib.create_state(spec, self.device,
                                             packed=self.packed)
                for name, spec in self.tables.items()}

    @staticmethod
    def rows_at(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """rows[pos] with -1 (and positions outside rows) reading -1."""
        U = rows.shape[0]
        padded = torch.cat([rows, rows.new_full((1,), -1)])
        return padded[torch.where((pos < 0) | (pos >= U), U, pos.long())]

    @classmethod
    def new_rows_from(cls, rows: torch.Tensor, tin: Dict) -> torch.Tensor:
        """The new rows of a structure-of-arrays step's inputs: its
        "new_rows" [K], rows[new_pos] [K], or, from the multi-host
        trainer's mask, rows where new_mask is set and -1 elsewhere [U]."""
        if "new_mask" in tin:
            return torch.where(tin["new_mask"] > 0, rows, -1)
        if "new_pos" in tin:
            return cls.rows_at(rows, tin["new_pos"])
        return tin["new_rows"]

    @torch.no_grad()
    def admit_rows(self, states: Dict, inputs: Dict, seed: int,
                   step: int) -> Dict:
        """Initialise each structure-of-arrays table's newly admitted rows
        in place, with the new-row init's seed (seed, step, table index,
        shard): `init_rows` of new_rows_from(...) (one `index_copy_` an
        array); a tiered table's revived rows then get their archived
        state (`restore_packed_rows` of "revive_rows", or of the rows at
        "revive_pos"). A packed engine admits inside fused_lookup."""
        for i, (tname, tin) in enumerate(sorted(inputs.items())):
            spec = self.tables[tname]
            self._generator.manual_seed(_init_seed(seed, step, i, self.shard))
            table_lib.init_rows(spec, states[tname],
                                self.new_rows_from(tin["rows"], tin),
                                self._generator)
            revive = tin.get("revive_rows")
            if revive is None and tin.get("revive_pos") is not None:
                revive = self.rows_at(tin["rows"], tin["revive_pos"])
            if revive is not None and len(revive):
                table_lib.restore_packed_rows(spec, states[tname], revive,
                                              tin["revive_values"])
        return states

    @torch.no_grad()
    def apply_gradients(self, states: Dict, inputs: Dict,
                        unique_grads: Dict[str, torch.Tensor], step: int,
                        seed: int = 0) -> Dict:
        """Per-segment optimize of each structure-of-arrays table's unique
        rows, in place (table.apply_gradients); a bf16 table with
        stochastic rounding
        narrows its params with K3, keyed by (seed, step, table index,
        shard) in fused_apply's domain, as the JAX package keys its
        per-(step, table, shard) write-back."""
        for i, (tname, tin) in enumerate(sorted(inputs.items())):
            table_lib.apply_gradients(
                self.tables[tname], states[tname], tin["rows"],
                unique_grads[tname], step,
                seed=_round_seed(seed, step, i, self.shard))
        return states

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
                words = self._index_words(tname, n)
                chunk = wire[off:off + words]
                off += words
                if self.wide(tname):    # int32 words, -1 invalid
                    index[f.name] = chunk.reshape(batch_size, f.max_length)
                    continue
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
        package's threefry draws; `self.shard` keys each shard's draws
        apart. A tiered table's revived rows
        (`revive_pos`, `revive_values` in its inputs) are laid over the
        init: their archived state replaces the first `state_width`
        columns and the columns after them read zero.

        Returns (prows {table: [U, P] f32}, unique {table: [U, dim] f32}),
        f32 for a bf16 pool too."""
        prows, unique = {}, {}
        for i, (tname, tin) in enumerate(sorted(inputs.items())):
            spec = self.tables[tname]
            rows = tin["rows"]
            p = table_lib.gather_packed(spec, states[tname], rows)
            self._generator.manual_seed(_init_seed(seed, step, i, self.shard))
            init = table_lib.init_packed(spec, self._generator, rows.shape[0],
                                         self.device)
            p = torch.where((tin["new_mask"] > 0)[:, None], init, p)
            if tin.get("revive_pos") is not None and len(tin["revive_pos"]):
                _overlay_revived(p, tin["revive_pos"], tin["revive_values"])
            prows[tname] = p
            unique[tname] = table_lib.params_of(spec, p)
        return prows, unique

    def fused_apply(self, states: Dict, inputs: Dict, prows: Dict,
                    unique_grads: Dict[str, torch.Tensor], step: int,
                    seed: int = 0) -> Dict:
        """Optimize the gathered packed rows and write them back in place
        with ONE scatter (K2) per table; a bf16 pool with stochastic
        rounding narrows them first with K3, keyed by (seed, step, table
        index, shard)."""
        for i, (tname, tin) in enumerate(sorted(inputs.items())):
            spec = self.tables[tname]
            new_p = table_lib.optimize_packed(spec, prows[tname],
                                              unique_grads[tname], step)
            table_lib.scatter_packed(spec, states[tname], tin["rows"], new_p,
                                     seed=_round_seed(seed, step, i,
                                                     self.shard))
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
        by (seed, step, table index, shard) in a domain of its own
        (_defer_seed)."""
        for i, tname in enumerate(sorted(rows)):
            table_lib.scatter_packed(self.tables[tname], states[tname],
                                     rows[tname], values[tname],
                                     seed=_defer_seed(seed, step, i,
                                                     self.shard))
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

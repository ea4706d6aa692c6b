"""Python wrappers over the native host sparse core (the port's copy).

`HostStore` is the collisionless fid -> row map of one table with admission
filtering and expiry eviction; it holds no float data, only row indices into
the device pool. It also records the fids touched since the last drain (the streaming push
reads them) and saves and restores its admission filter (checkpoints).
`Batcher` owns the dedup scratch of one table; `Batcher2D` the two-level
dedup of the sharded trainer's bucketed all-to-all exchange (per table
shard, then per batch shard). `prepare_wire_multi` is the
fused per-step host prepare (dedup + map + wire pack for every table in one
native call). `shard_of` / `shard_of_batch` are the hash that routes a fid
to a shard (checkpoint resharding, row-sharded serving). Same C++ and the
same semantics as the JAX package's host store.
"""

from __future__ import annotations

import ctypes
import enum
from typing import Optional, Tuple

import numpy as np

from monolith_tpu_torch import native


class FilterKind(enum.IntEnum):
    NONE = 0
    SLIDING = 1       # sliding count-min window (ref SlidingHashFilter)
    PROBABILISTIC = 2  # stateless equal-probability admission
    PROBABILISTIC_UNEQUAL = 3  # admit prob proportional to batch count


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class HostStore:
    """Collisionless fid -> row index map for one table shard."""

    def __init__(self,
                 row_capacity: int,
                 filter_kind: FilterKind = FilterKind.NONE,
                 admit_threshold: int = 1,
                 filter_capacity: int = 0,
                 filter_splits: int = 5,
                 seed: int = 0):
        self._lib = native.get_lib()
        self.row_capacity = int(row_capacity)
        self.filter_kind = FilterKind(filter_kind)
        self.admit_threshold = int(admit_threshold)
        self._h = self._lib.mt_store_new(
            self.row_capacity, int(filter_kind), int(filter_capacity),
            int(filter_splits), int(admit_threshold), int(seed))
        self.last_rejected = 0  # budget-rejected ids from the last map call

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mt_store_free(h)
            self._h = None

    def map_train(self, fids: np.ndarray, ts: int, new_cap: Optional[int] = None,
                  record_touch: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Map fids to rows for a training step, admitting new ids subject
        to the admission filter and the per-call `new_cap` budget. Returns
        (rows int32 [n] with -1 for filtered/rejected/out-of-capacity,
        new_rows int32 [k], new_fids int64 [k])."""
        fids = np.ascontiguousarray(fids, dtype=np.int64)
        n = fids.size
        if new_cap is None:
            new_cap = n
        rows = np.empty(n, dtype=np.int32)
        new_rows = np.empty(new_cap, dtype=np.int32)
        new_fids = np.empty(new_cap, dtype=np.int64)
        new_count = np.zeros(1, dtype=np.int64)
        self._lib.mt_store_map_train(
            self._h, _ptr(fids, ctypes.c_int64), n, ts,
            _ptr(rows, ctypes.c_int32), _ptr(new_rows, ctypes.c_int32),
            _ptr(new_fids, ctypes.c_int64), new_cap,
            _ptr(new_count, ctypes.c_int64), 1 if record_touch else 0)
        k = min(int(new_count[0]), new_cap)
        self.last_rejected = int(new_count[0]) - k
        return rows, new_rows[:k], new_fids[:k]

    def map_train_pos(self, fids: np.ndarray, ts: int,
                      new_cap: Optional[int] = None,
                      record_touch: bool = False,
                      counts: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """map_train that also returns each new id's position within `fids`
        (strictly increasing int32 [k]). `counts` (int32 [n], optional):
        each fid's occurrences in the batch, which the admission filters
        consume. The budget-rejected count is `self.last_rejected`."""
        fids = np.ascontiguousarray(fids, dtype=np.int64)
        n = fids.size
        if new_cap is None:
            new_cap = n
        rows = np.empty(n, dtype=np.int32)
        new_rows = np.empty(new_cap, dtype=np.int32)
        new_fids = np.empty(new_cap, dtype=np.int64)
        new_pos = np.empty(new_cap, dtype=np.int32)
        new_count = np.zeros(1, dtype=np.int64)
        tail = (_ptr(rows, ctypes.c_int32), _ptr(new_rows, ctypes.c_int32),
                _ptr(new_fids, ctypes.c_int64), _ptr(new_pos, ctypes.c_int32),
                new_cap, _ptr(new_count, ctypes.c_int64),
                1 if record_touch else 0)
        if counts is not None:
            counts = np.ascontiguousarray(counts, dtype=np.int32)
            self._lib.mt_store_map_train_pos2(
                self._h, _ptr(fids, ctypes.c_int64), n, ts,
                _ptr(counts, ctypes.c_int32), *tail)
        else:
            self._lib.mt_store_map_train_pos(
                self._h, _ptr(fids, ctypes.c_int64), n, ts, *tail)
        k = min(int(new_count[0]), new_cap)
        self.last_rejected = int(new_count[0]) - k
        return rows, new_rows[:k], new_fids[:k], new_pos[:k]

    def lookup(self, fids: np.ndarray) -> np.ndarray:
        """Read-only lookup; missing ids map to -1."""
        fids = np.ascontiguousarray(fids, dtype=np.int64)
        rows = np.empty(fids.size, dtype=np.int32)
        self._lib.mt_store_lookup(self._h, _ptr(fids, ctypes.c_int64),
                                  fids.size, _ptr(rows, ctypes.c_int32))
        return rows

    def assign(self, fids: np.ndarray, ts: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Map fids to rows, unconditionally admitting."""
        fids = np.ascontiguousarray(fids, dtype=np.int64)
        n = fids.size
        rows = np.empty(n, dtype=np.int32)
        new_rows = np.empty(n, dtype=np.int32)
        new_fids = np.empty(n, dtype=np.int64)
        new_count = np.zeros(1, dtype=np.int64)
        self._lib.mt_store_assign(
            self._h, _ptr(fids, ctypes.c_int64), n, ts,
            _ptr(rows, ctypes.c_int32), _ptr(new_rows, ctypes.c_int32),
            _ptr(new_fids, ctypes.c_int64), n, _ptr(new_count, ctypes.c_int64))
        k = int(new_count[0])
        return rows, new_rows[:k], new_fids[:k]

    def evict_expired(self, expire_before: int, return_fids: bool = False):
        """Evict every entry whose last update ts < expire_before. Returns
        the freed row indices (int32), or (rows, fids) with
        return_fids=True (a tiered table spills those fids' rows)."""
        cap = self.size()
        out = np.empty(max(cap, 1), dtype=np.int32)
        if return_fids:
            fids = np.empty(max(cap, 1), dtype=np.int64)
            n = min(self._lib.mt_store_evict_expired2(
                self._h, expire_before, _ptr(out, ctypes.c_int32),
                _ptr(fids, ctypes.c_int64), cap), cap)
            return out[:n], fids[:n]
        n = self._lib.mt_store_evict_expired(self._h, expire_before,
                                             _ptr(out, ctypes.c_int32), cap)
        return out[:min(n, cap)]

    def size(self) -> int:
        return int(self._lib.mt_store_size(self._h))

    def save(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Dump (fids, rows, timestamps, counts)."""
        n = self.size()
        fids = np.empty(n, dtype=np.int64)
        rows = np.empty(n, dtype=np.int32)
        tss = np.empty(n, dtype=np.uint32)
        counts = np.empty(n, dtype=np.uint32)
        m = self._lib.mt_store_save(self._h, _ptr(fids, ctypes.c_int64),
                                    _ptr(rows, ctypes.c_int32),
                                    _ptr(tss, ctypes.c_uint32),
                                    _ptr(counts, ctypes.c_uint32))
        if m != n:
            raise RuntimeError(f"HostStore.save wrote {m} entries, expected {n}")
        return fids, rows, tss, counts

    def restore(self, fids: np.ndarray, rows: np.ndarray,
                tss: Optional[np.ndarray] = None,
                counts: Optional[np.ndarray] = None) -> None:
        """Replace the map's contents with exactly these entries; rows not
        listed become free and are handed out lowest first."""
        fids = np.ascontiguousarray(fids, dtype=np.int64)
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        n = fids.size
        tss = np.ascontiguousarray(
            tss if tss is not None else np.zeros(n), dtype=np.uint32)
        counts = np.ascontiguousarray(
            counts if counts is not None else np.zeros(n), dtype=np.uint32)
        ok = self._lib.mt_store_restore(
            self._h, _ptr(fids, ctypes.c_int64), _ptr(rows, ctypes.c_int32),
            _ptr(tss, ctypes.c_uint32), _ptr(counts, ctypes.c_uint32), n)
        if not ok:
            raise ValueError("HostStore.restore failed: duplicate fids/rows "
                             "or rows out of range")

    # --- touched keys (online parameter sync) ---

    def touched_size(self) -> int:
        return int(self._lib.mt_store_touched_size(self._h))

    def drain_touched(self, cap: Optional[int] = None) -> np.ndarray:
        """Drain the (deduplicated) fids touched since the last drain."""
        if cap is None:
            cap = self.touched_size()
        out = np.empty(max(cap, 1), dtype=np.int64)
        n = self._lib.mt_store_drain_touched(self._h, _ptr(out, ctypes.c_int64), cap)
        return out[:n]

    # --- filter state ---

    def filter_estimate(self, fid: int) -> int:
        """Estimated occurrence count of `fid` in the admission filter's
        sliding window (-1 for a store without a filter)."""
        return int(self._lib.mt_store_filter_estimate(self._h, int(fid)))

    def filter_save(self) -> bytes:
        """The admission filter's state (b"" for a store without one)."""
        n = self._lib.mt_store_filter_byte_size(self._h)
        if n == 0:
            return b""
        buf = np.empty(n, dtype=np.uint8)
        m = self._lib.mt_store_filter_save(self._h, _ptr(buf, ctypes.c_uint8))
        return buf[:m].tobytes()

    def filter_restore(self, data: bytes) -> None:
        if not data:
            return
        buf = np.frombuffer(data, dtype=np.uint8).copy()
        ok = self._lib.mt_store_filter_restore(self._h, _ptr(buf, ctypes.c_uint8), buf.size)
        if not ok:
            raise ValueError("filter_restore failed (shape mismatch)")


class Batcher:
    """The dedup scratch of one table: used by prepare_wire_multi in
    training, and directly (`dedup`) by the serving model's prepare."""

    def __init__(self, expected_unique: int = 4096):
        self._lib = native.get_lib()
        self._h = self._lib.mt_batcher_new(int(expected_unique))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mt_batcher_free(h)
            self._h = None

    def dedup(self, values: np.ndarray, num_shards: int, shard_cap: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Dedup/shard a flat fid stream (padding fid == -1).

        Returns (unique [num_shards, shard_cap] int64 padded with -1,
                 index [n] int32 into unique.flatten() with -1 for padding,
                 shard_counts [num_shards] int32,
                 overflow count of unique ids dropped for capacity).
        """
        values = np.ascontiguousarray(values, dtype=np.int64).ravel()
        unique = np.empty((num_shards, shard_cap), dtype=np.int64)
        index = np.empty(values.size, dtype=np.int32)
        counts = np.empty(num_shards, dtype=np.int32)
        overflow = self._lib.mt_batcher_dedup(
            self._h, _ptr(values, ctypes.c_int64), values.size,
            num_shards, shard_cap, _ptr(unique, ctypes.c_int64),
            _ptr(index, ctypes.c_int32), _ptr(counts, ctypes.c_int32))
        return unique, index, counts, int(overflow)

    def dedup_counts(self, values: np.ndarray, num_shards: int,
                     shard_cap: int):
        """dedup that also returns each unique id's occurrences in the
        batch ([num_shards, shard_cap] int32, the layout of `unique`), which
        the admission filters consume. Returns (unique, index, counts,
        occurrences, overflow)."""
        values = np.ascontiguousarray(values, dtype=np.int64).ravel()
        unique = np.empty((num_shards, shard_cap), dtype=np.int64)
        index = np.empty(values.size, dtype=np.int32)
        counts = np.empty(num_shards, dtype=np.int32)
        occ = np.empty((num_shards, shard_cap), dtype=np.int32)
        overflow = self._lib.mt_batcher_dedup2(
            self._h, _ptr(values, ctypes.c_int64), values.size,
            num_shards, shard_cap, _ptr(unique, ctypes.c_int64),
            _ptr(index, ctypes.c_int32), _ptr(counts, ctypes.c_int32),
            _ptr(occ, ctypes.c_int32))
        return unique, index, counts, occ, int(overflow)


class Batcher2D:
    """Two-level dedup for the bucketed all-to-all exchange: the unique ids
    of each table shard (for the host map and the shard's local gather),
    and per (table shard, batch shard) a bucket of positions into that
    shard's unique list: the rows that batch shard reads from it."""

    def __init__(self, expected_unique: int = 4096):
        self._lib = native.get_lib()
        self._h = self._lib.mt_batcher2d_new(int(expected_unique))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mt_batcher2d_free(h)
            self._h = None

    def _run(self, values, num_batch_shards, num_shards, global_cap,
             bucket_cap, with_occurrences):
        values = np.ascontiguousarray(values, dtype=np.int64).ravel()
        n, S, D = values.size, num_shards, num_batch_shards
        if n % D:
            raise ValueError(f"{n} values do not split into {D} batch "
                             f"shards")
        unique = np.empty((S, global_cap), dtype=np.int64)
        counts = np.empty(S, dtype=np.int32)
        bucket_idx = np.empty((S, D, bucket_cap), dtype=np.int32)
        bucket_counts = np.empty((S, D), dtype=np.int32)
        index = np.empty(n, dtype=np.int32)
        args = [self._h, _ptr(values, ctypes.c_int64), n, D, S, global_cap,
                bucket_cap, _ptr(unique, ctypes.c_int64),
                _ptr(counts, ctypes.c_int32),
                _ptr(bucket_idx, ctypes.c_int32),
                _ptr(bucket_counts, ctypes.c_int32),
                _ptr(index, ctypes.c_int32)]
        if with_occurrences:
            occ = np.empty((S, global_cap), dtype=np.int32)
            overflow = self._lib.mt_batcher2d_dedup2(
                *args, _ptr(occ, ctypes.c_int32))
            return (unique, counts, bucket_idx, bucket_counts, index, occ,
                    int(overflow))
        overflow = self._lib.mt_batcher2d_dedup(*args)
        return unique, counts, bucket_idx, bucket_counts, index, int(overflow)

    def dedup(self, values: np.ndarray, num_batch_shards: int,
              num_shards: int, global_cap: int, bucket_cap: int):
        """values: flat int64, batch-shard-major (length divisible by
        num_batch_shards), padding fid == -1.

        Returns (unique [S, global_cap] int64 padded with -1,
                 counts [S] int32,
                 bucket_idx [S, D, bucket_cap] int32 padded with -1:
                   positions into shard s's unique list,
                 bucket_counts [S, D] int32,
                 index [n] int32: per value, its row of its batch shard's
                   receive buffer [S * bucket_cap]; -1 for padding and for
                   ids that overflowed a bucket or a shard,
                 overflow count)."""
        return self._run(values, num_batch_shards, num_shards, global_cap,
                         bucket_cap, False)

    def dedup2(self, values: np.ndarray, num_batch_shards: int,
               num_shards: int, global_cap: int, bucket_cap: int):
        """dedup that also returns each unique id's occurrences in the
        batch ([S, global_cap] int32, the layout of `unique`), which the
        admission filters consume. Returns (unique, counts, bucket_idx,
        bucket_counts, index, occurrences, overflow)."""
        return self._run(values, num_batch_shards, num_shards, global_cap,
                         bucket_cap, True)


#: a table's index words on the wire (`prepare_wire_multi`'s `widths`):
#: packed int16 pairs; int32 words, each unique id counted once a step by
#: the store's admission; int32 words, each id's occurrences in the step
#: counted (prepare_batch's two ways of mapping ids)
NARROW, WIDE, WIDE_COUNTED = 0, 1, 2


def prepare_wire_multi(batchers, stores, table_streams, ts: int,
                       unique_caps, new_caps, record_touch: bool,
                       wire_out: np.ndarray, wire_offsets: np.ndarray,
                       widths=NARROW) -> np.ndarray:
    """Multi-table fused host prepare: ONE native call for ALL tables, each
    table's dedup+map+pack running as one task on the native thread pool
    (largest table first), with the interpreter lock released.
    `table_streams` is a list of per-table stream lists (contiguous int64);
    `unique_caps`/`new_caps` are per-table step capacities (ints or [T]
    sequences); `widths` (NARROW, WIDE or WIDE_COUNTED, or [T] of them)
    lays a wide table's index words as one int32 a position in place of
    packed int16 pairs; `wire_offsets` [T+1] gives each table's word
    offset in `wire_out` (contiguous int32). Returns stats as an int64
    [T, 5] array (overflow, new, unique, filtered, new_rejected per
    table)."""
    T = len(batchers)
    flat = [s for streams in table_streams for s in streams]
    n = len(flat)
    ptrs = (ctypes.POINTER(ctypes.c_int64) * n)(
        *[_ptr(s, ctypes.c_int64) for s in flat])
    sizes = np.array([s.size for s in flat], dtype=np.int64)
    soffs = np.zeros(T + 1, dtype=np.int64)
    np.cumsum([len(st) for st in table_streams], out=soffs[1:])
    bh = (ctypes.c_void_p * T)(*[b._h for b in batchers])
    sh = (ctypes.c_void_p * T)(*[s._h for s in stores])
    ucaps = np.broadcast_to(np.asarray(unique_caps, np.int64),
                            (T,)).copy()
    ncaps = np.broadcast_to(np.asarray(new_caps, np.int64), (T,)).copy()
    widths = np.broadcast_to(np.asarray(widths, np.int32), (T,)).copy()
    stats = np.zeros((T, 5), dtype=np.int64)
    lib = batchers[0]._lib
    words = lib.mt_prepare_wire_multi_wide(
        T, bh, sh, ptrs, _ptr(sizes, ctypes.c_int64),
        _ptr(soffs, ctypes.c_int64), _ptr(wire_offsets, ctypes.c_int64),
        ts, _ptr(ucaps, ctypes.c_int64), _ptr(ncaps, ctypes.c_int64),
        _ptr(widths, ctypes.c_int32), 1 if record_touch else 0,
        _ptr(wire_out, ctypes.c_int32), _ptr(stats, ctypes.c_int64))
    if words != wire_out.size:
        raise RuntimeError(f"prepare_wire_multi wrote {words} words into a "
                           f"{wire_out.size}-word wire")
    return stats


def host_threads() -> int:
    """Worker threads in the native host pool (0 = inline execution)."""
    return int(native.get_lib().mt_host_threads())


def shard_of(fid: int, num_shards: int) -> int:
    return int(native.get_lib().mt_shard_of(int(fid), int(num_shards)))


def shard_of_batch(fids: np.ndarray, num_shards: int) -> np.ndarray:
    """Vectorized shard_of: splitmix64(fid) % num_shards over a whole array
    (numpy uint64 wrap-around matches the C++ arithmetic exactly)."""
    x = np.asarray(fids).astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(num_shards)).astype(np.int64)

"""Python wrappers over the native host sparse core (the port's copy).

`HostStore` is the collisionless fid -> row map of one table with admission
filtering; it holds no float data, only row indices into the device pool.
`Batcher` owns the dedup scratch of one table. `prepare_wire_multi` is the
fused per-step host prepare (dedup + map + wire pack for every table in one
native call). Same C++ and the same semantics as the JAX package's host store.
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


class Batcher:
    """The dedup scratch of one table, used by prepare_wire_multi."""

    def __init__(self, expected_unique: int = 4096):
        self._lib = native.get_lib()
        self._h = self._lib.mt_batcher_new(int(expected_unique))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mt_batcher_free(h)
            self._h = None


def prepare_wire_multi(batchers, stores, table_streams, ts: int,
                       unique_caps, new_caps, record_touch: bool,
                       wire_out: np.ndarray, wire_offsets: np.ndarray
                       ) -> np.ndarray:
    """Multi-table fused host prepare: ONE native call for ALL tables, each
    table's dedup+map+pack running as one task on the native thread pool.
    `table_streams` is a list of per-table stream lists (contiguous int64);
    `unique_caps`/`new_caps` are per-table step capacities (ints or [T]
    sequences); `wire_offsets` [T+1] gives each table's word offset in
    `wire_out` (contiguous int32). Returns stats as an int64 [T, 5] array
    (overflow, new, unique, filtered, new_rejected per table)."""
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
    stats = np.zeros((T, 5), dtype=np.int64)
    lib = batchers[0]._lib
    words = lib.mt_prepare_wire_multi(
        T, bh, sh, ptrs, _ptr(sizes, ctypes.c_int64),
        _ptr(soffs, ctypes.c_int64), _ptr(wire_offsets, ctypes.c_int64),
        ts, _ptr(ucaps, ctypes.c_int64), _ptr(ncaps, ctypes.c_int64),
        1 if record_touch else 0,
        _ptr(wire_out, ctypes.c_int32), _ptr(stats, ctypes.c_int64))
    if words != wire_out.size:
        raise RuntimeError(f"prepare_wire_multi wrote {words} words into a "
                           f"{wire_out.size}-word wire")
    return stats


def host_threads() -> int:
    """Worker threads in the native host pool (0 = inline execution)."""
    return int(native.get_lib().mt_host_threads())

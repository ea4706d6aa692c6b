"""ctypes loader for the native host library (the port's own build of cpp/).

The host sparse core (collisionless id map, dedup, wire packing) is the same
C++ as the JAX package's; the port compiles it itself into
`monolith_tpu_torch/_build/` (see build.py) and declares only the C entry
points it calls.
"""

from __future__ import annotations

import ctypes
import threading

from monolith_tpu_torch import build

_lock = threading.Lock()
_lib = None

c_i64_p = ctypes.POINTER(ctypes.c_int64)
c_i32_p = ctypes.POINTER(ctypes.c_int32)
c_u32_p = ctypes.POINTER(ctypes.c_uint32)
c_u8_p = ctypes.POINTER(ctypes.c_uint8)


def _declare(lib: ctypes.CDLL) -> None:
    d = lib
    d.mt_store_new.restype = ctypes.c_void_p
    d.mt_store_new.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                               ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64]
    d.mt_store_free.argtypes = [ctypes.c_void_p]
    d.mt_store_map_train.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_uint32,
        c_i32_p, c_i32_p, c_i64_p, ctypes.c_int64, c_i64_p, ctypes.c_int32]
    d.mt_store_map_train_pos.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_uint32,
        c_i32_p, c_i32_p, c_i64_p, c_i32_p, ctypes.c_int64, c_i64_p,
        ctypes.c_int32]
    d.mt_store_map_train_pos2.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_uint32, c_i32_p,
        c_i32_p, c_i32_p, c_i64_p, c_i32_p, ctypes.c_int64, c_i64_p,
        ctypes.c_int32]
    d.mt_store_lookup.argtypes = [ctypes.c_void_p, c_i64_p, ctypes.c_int64, c_i32_p]
    d.mt_store_assign.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_uint32,
        c_i32_p, c_i32_p, c_i64_p, ctypes.c_int64, c_i64_p]
    d.mt_store_evict_expired.restype = ctypes.c_int64
    d.mt_store_evict_expired.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         c_i32_p, ctypes.c_int64]
    d.mt_store_evict_expired2.restype = ctypes.c_int64
    d.mt_store_evict_expired2.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                          c_i32_p, c_i64_p, ctypes.c_int64]
    d.mt_store_size.restype = ctypes.c_int64
    d.mt_store_size.argtypes = [ctypes.c_void_p]
    d.mt_store_save.restype = ctypes.c_int64
    d.mt_store_save.argtypes = [ctypes.c_void_p, c_i64_p, c_i32_p, c_u32_p, c_u32_p]
    d.mt_store_restore.restype = ctypes.c_int32
    d.mt_store_restore.argtypes = [ctypes.c_void_p, c_i64_p, c_i32_p, c_u32_p, c_u32_p, ctypes.c_int64]
    d.mt_store_drain_touched.restype = ctypes.c_int64
    d.mt_store_drain_touched.argtypes = [ctypes.c_void_p, c_i64_p, ctypes.c_int64]
    d.mt_store_touched_size.restype = ctypes.c_int64
    d.mt_store_touched_size.argtypes = [ctypes.c_void_p]
    d.mt_store_filter_byte_size.restype = ctypes.c_int64
    d.mt_store_filter_byte_size.argtypes = [ctypes.c_void_p]
    d.mt_store_filter_save.restype = ctypes.c_int64
    d.mt_store_filter_save.argtypes = [ctypes.c_void_p, c_u8_p]
    d.mt_store_filter_restore.restype = ctypes.c_int32
    d.mt_store_filter_restore.argtypes = [ctypes.c_void_p, c_u8_p, ctypes.c_int64]
    d.mt_store_filter_estimate.restype = ctypes.c_int64
    d.mt_store_filter_estimate.argtypes = [ctypes.c_void_p, ctypes.c_int64]

    d.mt_batcher_new.restype = ctypes.c_void_p
    d.mt_batcher_new.argtypes = [ctypes.c_int64]
    d.mt_batcher_free.argtypes = [ctypes.c_void_p]
    d.mt_batcher_dedup.restype = ctypes.c_int64
    d.mt_batcher_dedup.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, c_i64_p, c_i32_p, c_i32_p]
    d.mt_batcher_dedup2.restype = ctypes.c_int64
    d.mt_batcher_dedup2.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, c_i64_p, c_i32_p, c_i32_p, c_i32_p]
    d.mt_shard_of.restype = ctypes.c_int32
    d.mt_shard_of.argtypes = [ctypes.c_int64, ctypes.c_int32]
    d.mt_prepare_wire_multi_wide.restype = ctypes.c_int64
    d.mt_prepare_wire_multi_wide.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(c_i64_p), c_i64_p,
        c_i64_p, c_i64_p, ctypes.c_uint32, c_i64_p, c_i64_p, c_i32_p,
        ctypes.c_int32, c_i32_p, c_i64_p]
    d.mt_host_threads.restype = ctypes.c_int32
    d.mt_host_threads.argtypes = []

    d.mt_batcher2d_new.restype = ctypes.c_void_p
    d.mt_batcher2d_new.argtypes = [ctypes.c_int64]
    d.mt_batcher2d_free.argtypes = [ctypes.c_void_p]
    d.mt_batcher2d_dedup.restype = ctypes.c_int64
    d.mt_batcher2d_dedup.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        c_i64_p, c_i32_p, c_i32_p, c_i32_p, c_i32_p]
    d.mt_batcher2d_dedup2.restype = ctypes.c_int64
    d.mt_batcher2d_dedup2.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        c_i64_p, c_i32_p, c_i32_p, c_i32_p, c_i32_p, c_i32_p]


def get_lib() -> ctypes.CDLL:
    """Return the loaded native library, building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build.build_host_library())
            _declare(lib)
            _lib = lib
    return _lib

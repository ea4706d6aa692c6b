"""Row gather (K1) and row scatter (K2) over a packed embedding pool.

`gather_rows` replaces monolith_tpu/ops/scatter.py::gather_rows and
`scatter_rows` replaces ::scatter_rows, the TPU's pipelined per-row DMA
kernels. On the card each launches a CUDA kernel from csrc/rows.cu
(sm_90a, built at first use by build.py, bound through ctypes):

- K1: out[i] = pool[rows[i]], zeros for rows outside [0, cap) — written by
  the kernel itself, so table.gather_packed needs no separate select.
- K2: pool[rows[i]] = values[i] for rows in [0, cap), in place; rows are
  unique (host-deduped), so plain stores suffice.

Both are pure data movement, bounded by HBM bytes: at the main path's
shapes (pool [2^21, 128] f32, 32768 rows) about 33.5 MB, ~10 us at
3.35 TB/s. Design: one warp per row, 16 bytes a lane, coalesced; a
grid-stride loop over rows (see the note in csrc/rows.cu).

On a CPU tensor a wrapper runs its plain PyTorch version
(`gather_rows_plain`, `scatter_rows_plain`, same semantics). On a CUDA
tensor it launches the kernel or raises; it never falls back. Each wrapper
counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from monolith_tpu_torch import build

_lock = threading.Lock()
_lib = None


def kernel_library() -> ctypes.CDLL:
    """The built K1/K2 library (compiled with nvcc at first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build.build_kernel_library())
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.mt_gather_rows.restype = ctypes.c_int
            lib.mt_gather_rows.argtypes = [vp, i64, vp, i64, vp, i64, vp]
            lib.mt_scatter_rows.restype = ctypes.c_int
            lib.mt_scatter_rows.argtypes = [vp, i64, vp, vp, i64, i64, vp]
            _lib = lib
    return _lib


def reset_launch_counts() -> None:
    gather_rows.launches = 0
    scatter_rows.launches = 0


def gather_rows_plain(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K1's plain version: pool[rows] with zeros for rows outside [0, cap)."""
    valid = (rows >= 0) & (rows < pool.shape[0])
    out = pool[torch.where(valid, rows, 0).long()]
    return torch.where(valid[:, None], out, torch.zeros((), dtype=pool.dtype,
                                                        device=pool.device))


def scatter_rows_plain(pool: torch.Tensor, rows: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """K2's plain version: pool[rows[i]] = values[i] for valid rows, in
    place; returns pool."""
    valid = (rows >= 0) & (rows < pool.shape[0])
    pool[rows[valid].long()] = values[valid]
    return pool


def _check_cuda(name: str, pool: torch.Tensor, rows: torch.Tensor,
                *others: torch.Tensor) -> int:
    """Validate what the kernel takes; returns the row width in bytes."""
    for t in (pool, rows) + others:
        if t.device.type != "cuda" or t.device != pool.device:
            raise ValueError(f"{name}: tensors must all be on one CUDA device "
                             f"or all on the CPU (got {t.device}, pool on "
                             f"{pool.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError(f"{name}: rows must be a 1-D int32 tensor "
                         f"(got {rows.dtype}, {tuple(rows.shape)})")
    if pool.dim() != 2:
        raise ValueError(f"{name}: pool must be [cap, width]")
    row_bytes = pool.shape[1] * pool.element_size()
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in (pool,) + others):
        raise ValueError(f"{name}: rows must be whole 16-byte vectors "
                         f"({row_bytes} B per row)")
    return row_bytes


def gather_rows(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[i] = pool[rows[i]]; rows outside [0, cap) read zeros.
    pool [cap, P], rows [n] int32 -> [n, P] of pool's dtype."""
    if pool.device.type == "cpu" and rows.device.type == "cpu":
        return gather_rows_plain(pool, rows)
    row_bytes = _check_cuda("gather_rows", pool, rows)
    out = torch.empty((rows.shape[0], pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    n = rows.shape[0]
    if n == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mt_gather_rows(pool.data_ptr(), pool.shape[0],
                                 rows.data_ptr(), n, out.data_ptr(),
                                 row_bytes, stream)
    if err:
        raise RuntimeError(f"gather_rows: kernel launch failed (CUDA error "
                           f"{err})")
    gather_rows.launches += 1
    return out


def scatter_rows(pool: torch.Tensor, rows: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """pool[rows[i]] = values[i] for rows in [0, cap); rows unique. Writes
    the pool in place and returns it. pool [cap, P], rows [n] int32,
    values [n, P] with values.dtype == pool.dtype."""
    if values.dtype != pool.dtype:
        raise ValueError(f"scatter_rows: values dtype {values.dtype} != pool "
                         f"dtype {pool.dtype}")
    if values.dim() != 2 or values.shape[1] != pool.shape[1] or \
            values.shape[0] != rows.shape[0]:
        raise ValueError(f"scatter_rows: values {tuple(values.shape)} do not "
                         f"match rows {tuple(rows.shape)} and pool width "
                         f"{pool.shape[1]}")
    if pool.device.type == "cpu" and rows.device.type == "cpu" and \
            values.device.type == "cpu":
        return scatter_rows_plain(pool, rows, values)
    row_bytes = _check_cuda("scatter_rows", pool, rows, values)
    n = rows.shape[0]
    if n == 0:
        return pool
    lib = kernel_library()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mt_scatter_rows(pool.data_ptr(), pool.shape[0],
                                  rows.data_ptr(), values.data_ptr(), n,
                                  row_bytes, stream)
    if err:
        raise RuntimeError(f"scatter_rows: kernel launch failed (CUDA error "
                           f"{err})")
    scatter_rows.launches += 1
    return pool


gather_rows.launches = 0
scatter_rows.launches = 0

"""Row gather (K1) and row scatter (K2) over a packed embedding pool.

`gather_rows` replaces monolith_tpu/ops/scatter.py::gather_rows and
`scatter_rows` replaces ::scatter_rows, the TPU's pipelined per-row DMA
kernels. On the card each launches a CUDA kernel from csrc/rows.cu
(sm_90a, built at first use by build.py, bound through ctypes):

- K1: out[i] = pool[rows[i]], zeros for rows outside [0, cap) — written by
  the kernel itself, so table.gather_packed needs no separate select.
- K2: pool[rows[i]] = values[i] for rows in [0, cap), in place; rows are
  unique (host-deduped), so plain stores suffice.

Both are pure data movement, bounded by HBM bytes: at the DeepFM path's
shapes (pool [2^21, 128] f32, 32768 rows of 512 B) about 33.5 MB; at the
multislot bf16 path's (pool [17 x 2^18, 128] bf16, 49152 rows of 256 B)
about 24 MB. The rows are a random draw over a pool of about 1 GiB, so
what keeps a kernel from its bound is latency: the index, then the row,
each a cold read. Design (see the note in csrc/rows.cu): a persistent grid
of 8-warp blocks; every warp owns a ring of `STAGES` stages in shared
memory and walks tiles of `tile_rows` indices; the rows are moved by
Hopper's bulk asynchronous copies (one per row between the pool and a
stage, one per tile between a stage and the contiguous side), completion
counted on one mbarrier a stage; the indices of a later tile are loaded
while an earlier tile drains. `tile_geometry`, `grid_size` and
`tile_spans` mirror the kernels' arithmetic, so that the CPU tests reach
it; `kernel_geometry` reads the C side's, for the card tests to hold the
two equal.

On a CPU tensor a wrapper runs its plain PyTorch version
(`gather_rows_plain`, `scatter_rows_plain`, same semantics). On a CUDA
tensor it launches the kernel or raises; it never falls back. Each wrapper
counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, Tuple

import torch

from monolith_tpu_torch import build


def declare_rows(lib: ctypes.CDLL) -> None:
    """The C interface of K1 and K2, which every build of them keeps."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.mt_gather_rows.restype = ctypes.c_int
    lib.mt_gather_rows.argtypes = [vp, i64, vp, i64, vp, i64, vp]
    lib.mt_scatter_rows.restype = ctypes.c_int
    lib.mt_scatter_rows.argtypes = [vp, i64, vp, vp, i64, i64, vp]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    declare_rows(lib)
    lib.mt_rows_geometry.restype = ctypes.c_int
    lib.mt_rows_geometry.argtypes = [i64, i64, ctypes.POINTER(i64)]
    lib.mt_noop.restype = ctypes.c_int
    lib.mt_noop.argtypes = [vp]


def kernel_library() -> ctypes.CDLL:
    """The built K1/K2 library (compiled with nvcc at first use)."""
    return build.load_kernel_library("rows", _declare)


#: csrc/rows.cu's constants: warps a block (each with its own ring), stages
#: a ring, the most bytes and rows of a stage, the shared memory one block
#: may use on an H100 (227 KB)
WARPS, STAGES, STAGE_BYTES, MAX_TILE_ROWS, MAX_SMEM = 8, 3, 8192, 32, 232448


def tile_geometry(row_bytes: int) -> Tuple[int, int]:
    """(tile_rows, shared-memory bytes a block) for rows of `row_bytes`: a
    stage holds as many rows as fit STAGE_BYTES, at least 1 and at most one
    a lane; a block holds WARPS x STAGES stages and an 8-byte mbarrier for
    each. Raises for a row that is no whole number of 16-byte vectors or
    too wide for the ring to fit."""
    if row_bytes <= 0 or row_bytes % 16:
        raise ValueError(f"rows must be whole 16-byte vectors ({row_bytes} B "
                         f"per row)")
    tile_rows = min(max(STAGE_BYTES // row_bytes, 1), MAX_TILE_ROWS)
    smem = WARPS * STAGES * (tile_rows * row_bytes + 8)
    if smem > MAX_SMEM:
        raise ValueError(f"rows of {row_bytes} B are too wide: {WARPS} x "
                         f"{STAGES} stages need {smem} B of shared memory "
                         f"(at most {MAX_SMEM})")
    return tile_rows, smem


def grid_size(n: int, tile_rows: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of the persistent grid: all the card holds at once, or fewer
    where n rows do not fill that many blocks' warps with a tile each."""
    tiles = -(-n // tile_rows)
    return min(-(-tiles // WARPS), blocks_per_sm * sms)


def tile_spans(n: int, tile_rows: int, grid: int
               ) -> Iterator[Tuple[int, int, int, int, int]]:
    """The kernels' walk: (block, warp, stage, start, stop) for every tile,
    in each warp's order. Warp `warp` of block `block` is warp number
    warp * grid + block of the grid and takes every (grid * WARPS)-th
    tile from there on, its k-th tile in stage k % STAGES."""
    tiles = -(-n // tile_rows)
    for block in range(grid):
        for warp in range(WARPS):
            mine = range(warp * grid + block, tiles, grid * WARPS)
            for k, t in enumerate(mine):
                yield (block, warp, k % STAGES, t * tile_rows,
                       min((t + 1) * tile_rows, n))


def kernel_geometry(n: int, row_bytes: int) -> Dict[str, int]:
    """What csrc/rows.cu computes for n rows of `row_bytes` on the current
    card (needs the card)."""
    out = (ctypes.c_int64 * 8)()
    err = kernel_library().mt_rows_geometry(n, row_bytes, out)
    if err:
        raise RuntimeError(f"mt_rows_geometry failed (CUDA error {err})")
    keys = ("warps", "stages", "tile_rows", "smem_bytes", "gather_grid",
            "scatter_grid", "blocks_per_sm", "sms")
    return dict(zip(keys, out))


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
    tile_geometry(row_bytes)  # raises for a width the kernels do not take
    if any(t.data_ptr() % 16 for t in (pool,) + others):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return row_bytes


def launch_gather(lib: ctypes.CDLL, pool: torch.Tensor, rows: torch.Tensor,
                  out: torch.Tensor, row_bytes: int) -> None:
    """Launch `lib`'s K1 on checked tensors (bench_rows.py passes another
    build's library here); raises if the launch is refused."""
    with torch.cuda.device(pool.device):
        err = lib.mt_gather_rows(pool.data_ptr(), pool.shape[0],
                                 rows.data_ptr(), rows.shape[0],
                                 out.data_ptr(), row_bytes,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gather_rows: kernel launch failed (CUDA error "
                           f"{err})")


def launch_scatter(lib: ctypes.CDLL, pool: torch.Tensor, rows: torch.Tensor,
                   values: torch.Tensor, row_bytes: int) -> None:
    """Launch `lib`'s K2 on checked tensors; raises if the launch is
    refused."""
    with torch.cuda.device(pool.device):
        err = lib.mt_scatter_rows(pool.data_ptr(), pool.shape[0],
                                  rows.data_ptr(), values.data_ptr(),
                                  rows.shape[0], row_bytes,
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scatter_rows: kernel launch failed (CUDA error "
                           f"{err})")


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
    launch_gather(kernel_library(), pool, rows, out, row_bytes)
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
    launch_scatter(kernel_library(), pool, rows, values, row_bytes)
    scatter_rows.launches += 1
    return pool


gather_rows.launches = 0
scatter_rows.launches = 0

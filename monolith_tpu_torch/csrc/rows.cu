// Row gather (K1) and row scatter (K2) over a packed embedding pool, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// monolith_tpu_torch/ops/scatter.py, launched on the caller's stream.
//
// Replaces monolith_tpu/ops/scatter.py::gather_rows and ::scatter_rows, the
// TPU's pipelined per-row DMA kernels. Both functions are pure data movement:
// each row is one packed pool row (128 f32 = 512 B on the main path), so the
// bound is bytes over HBM bandwidth (about 33.5 MB, ~10 us at 3.35 TB/s for
// 32768 rows). Design: one warp per row, each lane moving 16-byte vectors
// (a 512-byte row is exactly 32 lanes x one int4), so every row is one
// coalesced transaction; a grid-stride loop covers any number of rows. The
// kernels move bytes, not floats, so any row whose width is a multiple of
// 16 bytes is handled bit for bit.
//
// What does not carry over from the TPU: the 64K-row scalar-prefetch split
// (SMEM limit), the int32 view for 16-bit pools (Mosaic's row-slice tiling)
// and row_dma_supported(). Rows outside [0, cap) read zeros in K1 (inside
// the kernel, so the caller needs no separate select) and are skipped in
// K2. K2's rows are unique (host-deduped), so plain stores need no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int64_t kMaxBlocks = 1 << 16;

__global__ void gather_rows_kernel(const int4* __restrict__ pool, int64_t cap,
                                   const int32_t* __restrict__ rows, int64_t n,
                                   int4* __restrict__ out, int64_t vecs) {
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
       i < n; i += stride) {
    const int32_t r = rows[i];
    int4* dst = out + i * vecs;
    if (r >= 0 && r < cap) {
      const int4* src = pool + (int64_t)r * vecs;
      for (int64_t c = lane; c < vecs; c += kWarp) dst[c] = src[c];
    } else {
      for (int64_t c = lane; c < vecs; c += kWarp) dst[c] = make_int4(0, 0, 0, 0);
    }
  }
}

__global__ void scatter_rows_kernel(int4* __restrict__ pool, int64_t cap,
                                    const int32_t* __restrict__ rows,
                                    const int4* __restrict__ values, int64_t n,
                                    int64_t vecs) {
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
       i < n; i += stride) {
    const int32_t r = rows[i];
    if (r < 0 || r >= cap) continue;
    int4* dst = pool + (int64_t)r * vecs;
    const int4* src = values + i * vecs;
    for (int64_t c = lane; c < vecs; c += kWarp) dst[c] = src[c];
  }
}

unsigned int blocks_for(int64_t n) {
  int64_t b = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// out[i] = pool[rows[i]] (zeros where rows[i] is outside [0, cap)).
// pool [cap, row_bytes], out [n, row_bytes]; row_bytes % 16 == 0 and both
// pointers 16-byte aligned (checked by the Python wrapper). n > 0.
int mt_gather_rows(const void* pool, int64_t cap, const int32_t* rows,
                   int64_t n, void* out, int64_t row_bytes, void* stream) {
  gather_rows_kernel<<<blocks_for(n), kWarp * kWarpsPerBlock, 0,
                       (cudaStream_t)stream>>>(
      (const int4*)pool, cap, rows, n, (int4*)out, row_bytes / 16);
  return (int)cudaGetLastError();
}

// pool[rows[i]] = values[i] for rows[i] in [0, cap), in place; rows unique.
int mt_scatter_rows(void* pool, int64_t cap, const int32_t* rows,
                    const void* values, int64_t n, int64_t row_bytes,
                    void* stream) {
  scatter_rows_kernel<<<blocks_for(n), kWarp * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(
      (int4*)pool, cap, rows, (const int4*)values, n, row_bytes / 16);
  return (int)cudaGetLastError();
}

}  // extern "C"

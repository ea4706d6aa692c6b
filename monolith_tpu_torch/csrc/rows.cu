// Row gather (K1) and row scatter (K2) over a packed embedding pool, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// monolith_tpu_torch/ops/scatter.py, launched on the caller's stream.
//
// Replaces monolith_tpu/ops/scatter.py::gather_rows and ::scatter_rows, the
// TPU's pipelined per-row DMA kernels. Both functions are pure data movement:
// each row is one packed pool row (512 B in an f32 pool, 256 B in a bf16
// pool), drawn at random from a pool of about 1 GiB, so nearly every row
// opens another DRAM page. The bound is bytes over HBM bandwidth; what keeps
// a kernel from it is the latency of two dependent reads (the index, then
// the row) and too few independent requests in flight.
//
// Design: the copy engine moves the rows, not the lanes. The TPU kernel's
// idea (one DMA per row, a ring of them in flight) on Hopper's bulk
// asynchronous copies (cp.async.bulk, no tensor map) and mbarriers:
//
// - Persistent grid: as many blocks as fit on the card (occupancy x SMs,
//   capped by the tiles), 8 warps a block. Every warp owns a ring of
//   kStages stages in dynamic shared memory, each `tile_rows` rows wide
//   with one mbarrier, and walks the tiles t = w, w + W, ... (w its number
//   among the grid's W warps, interleaved so that neighbouring tiles land
//   on different SMs). Warps share nothing, so nothing in the loop waits
//   for the block.
// - K1, per tile: the warp loads the tile's indices with one coalesced
//   load; lane j starts the bulk copy pool[rows[j]] -> stage[j] and adds
//   its bytes to the stage's mbarrier (arrive.expect_tx). Rows outside
//   [0, cap) are zeroed in the stage with ordinary stores, made visible to
//   the copy engine by fence.proxy.async. When the barrier's phase
//   completes, lane 0 stores the whole contiguous tile to `out` with ONE
//   bulk copy. A stage is refilled only after wait_group.read says its
//   store has read it; the indices of the refilling tile are loaded before
//   the wait on the tile that drains, off the critical path.
// - K2, per tile: the mirror. Lane 0 loads the contiguous values tile with
//   ONE bulk copy; when it has arrived, lane j stores stage[j] ->
//   pool[rows[j]] with its own bulk copy and skips rows outside [0, cap).
//   The indices are loaded one tile ahead.
// - No lane carries bytes, so a 256-byte row leaves no lane idle, and an SM
//   holds up to 24 stages (192 KB at 256- and 512-byte rows) in flight.
//
// The geometry (tile_rows, shared-memory bytes, grid) is mirrored in
// ops/scatter.py::tile_geometry / grid_size for the CPU tests;
// mt_rows_geometry reports what this file computes so the card tests can
// hold the two equal. The kernels move bytes, not floats: any row whose
// width is a multiple of 16 bytes is handled bit for bit. K2's rows are
// unique (host-deduped), so its stores need no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;            // warps a block, each with its own ring
constexpr int kThreads = kWarp * kWarps;
constexpr int kStages = 3;           // stages of a warp's ring
constexpr int kStageBytes = 8192;    // a stage holds at most this much ...
constexpr int kMaxTileRows = kWarp;  // ... and at most one row a lane
constexpr int kMaxSmem = 232448;     // 227 KB: what one block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's ordinary shared-memory accesses before later
// accesses of the copy engine (the asynchronous proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Blocks until the barrier has left the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, completion counted in bytes on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, tracked by this thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until all but the newest `kPending` groups of this thread have been read
// out of shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// One warp's share of the work: its ring, its barriers and its tiles.
struct Walk {
  unsigned char* ring;  // kStages stages of stage_bytes each
  uint64_t* bars;       // one mbarrier a stage
  int stage_bytes;
  int64_t first, stride, count;  // tiles first, first + stride, ...: count

  __device__ __forceinline__ Walk(unsigned char* smem, int64_t n, int row_bytes,
                                  int tile_rows) {
    const int warp = threadIdx.x / kWarp;
    stage_bytes = tile_rows * row_bytes;
    ring = smem + (size_t)warp * kStages * stage_bytes;
    bars = (uint64_t*)(smem + (size_t)kWarps * kStages * stage_bytes) +
           warp * kStages;
    const int64_t tiles = (n + tile_rows - 1) / tile_rows;
    stride = (int64_t)gridDim.x * kWarps;
    first = (int64_t)warp * gridDim.x + blockIdx.x;
    count = first < tiles ? (tiles - first + stride - 1) / stride : 0;
  }
  __device__ __forceinline__ int64_t tile(int64_t k) const {
    return first + k * stride;
  }
  __device__ __forceinline__ unsigned char* stage(int64_t k) const {
    return ring + (k % kStages) * stage_bytes;
  }
  __device__ __forceinline__ uint32_t bar(int64_t k) const {
    return smem_u32(bars + k % kStages);
  }
  // the k-th tile is its stage's (k / kStages)-th use
  __device__ __forceinline__ uint32_t parity(int64_t k) const {
    return (uint32_t)((k / kStages) & 1);
  }
  __device__ __forceinline__ void init_barriers(uint32_t arrivals) const {
    if (threadIdx.x % kWarp == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(bars + s), arrivals);
      fence_mbar_init();
      fence_proxy_async();
    }
    __syncwarp();
  }
};

// This lane's index in tile t, or -1 where the lane has no row there
// (`has_row` tells the two apart from a -1 that the caller passed).
__device__ __forceinline__ int32_t lane_index(const int32_t* __restrict__ rows,
                                              int64_t n, int64_t t,
                                              int tile_rows, bool* has_row) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = t * tile_rows + lane;
  *has_row = lane < tile_rows && i < n;
  return *has_row ? rows[i] : -1;
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const unsigned char* __restrict__ pool, int64_t cap,
                   const int32_t* __restrict__ rows, int64_t n,
                   unsigned char* __restrict__ out, int row_bytes,
                   int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Walk w(smem, n, row_bytes, tile_rows);
  if (w.count == 0) return;
  const int lane = threadIdx.x % kWarp;
  // every lane arrives once a tile: with its row's bytes, or without any
  w.init_barriers(kWarp);

  // Fills the k-th tile's stage: a bulk copy for each row inside [0, cap),
  // zeros for each other row of the tile.
  auto fill = [&](int64_t k, int32_t r, bool has_row) {
    unsigned char* stage = w.stage(k);
    const uint32_t bar = w.bar(k);
    const bool valid = r >= 0 && r < cap;
    unsigned zero_rows = __ballot_sync(0xffffffffu, has_row && !valid);
    if (zero_rows) {
      const int vecs = row_bytes / 16;
      do {
        const int j = __ffs(zero_rows) - 1;
        zero_rows &= zero_rows - 1;
        int4* dst = (int4*)(stage + j * row_bytes);
        for (int c = lane; c < vecs; c += kWarp) dst[c] = make_int4(0, 0, 0, 0);
      } while (zero_rows);
      fence_proxy_async();
    }
    if (valid) {
      mbar_arrive_expect_tx(bar, row_bytes);
      bulk_load(smem_u32(stage + lane * row_bytes),
                pool + (int64_t)r * row_bytes, row_bytes, bar);
    } else {
      mbar_arrive(bar);
    }
  };

  {  // all of the ring's index loads first, then their copies
    int32_t r[kStages];
    bool has_row[kStages] = {};
#pragma unroll
    for (int k = 0; k < kStages; ++k)
      r[k] = k < w.count
                 ? lane_index(rows, n, w.tile(k), tile_rows, &has_row[k])
                 : -1;
#pragma unroll
    for (int k = 0; k < kStages; ++k)
      if (k < w.count) fill(k, r[k], has_row[k]);
  }

  for (int64_t k = 0; k < w.count; ++k) {
    // The tile that refills the stage of tile k - 1, once that tile's
    // store has read the stage: its indices are asked for now.
    const int64_t next = k - 1 + kStages;
    const bool refill = k >= 1 && next < w.count;
    bool has_row = false;
    const int32_t r =
        refill ? lane_index(rows, n, w.tile(next), tile_rows, &has_row) : -1;
    if (lane == 0) {
      const int64_t row0 = w.tile(k) * tile_rows;
      const int64_t left = n - row0;
      const int tile_n = left < tile_rows ? (int)left : tile_rows;
      mbar_wait(w.bar(k), w.parity(k));
      bulk_store(out + row0 * row_bytes, smem_u32(w.stage(k)),
                 (uint32_t)(tile_n * row_bytes));
      bulk_commit();
      bulk_wait_read<1>();  // the store of tile k - 1 has read its stage
    }
    __syncwarp();
    if (refill) fill(next, r, has_row);
  }
  if (lane == 0) bulk_wait_all();
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(unsigned char* __restrict__ pool, int64_t cap,
                    const int32_t* __restrict__ rows,
                    const unsigned char* __restrict__ values, int64_t n,
                    int row_bytes, int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Walk w(smem, n, row_bytes, tile_rows);
  if (w.count == 0) return;
  const int lane = threadIdx.x % kWarp;
  // lane 0 arrives once a tile, with the bytes of the whole tile
  w.init_barriers(1);

  // Lane 0 asks for the k-th tile of `values`, one contiguous copy.
  auto fill = [&](int64_t k) {
    const int64_t row0 = w.tile(k) * tile_rows;
    const int64_t left = n - row0;
    const uint32_t bytes =
        (uint32_t)((left < tile_rows ? (int)left : tile_rows) * row_bytes);
    mbar_arrive_expect_tx(w.bar(k), bytes);
    bulk_load(smem_u32(w.stage(k)), values + row0 * row_bytes, bytes, w.bar(k));
  };

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kStages; ++k)
      if (k < w.count) fill(k);
  }
  bool has_row;
  int32_t r = lane_index(rows, n, w.tile(0), tile_rows, &has_row);
  for (int64_t k = 0; k < w.count; ++k) {
    // the next tile's indices, asked for before this tile is waited for
    bool next_has_row = false;
    const int32_t next_r =
        k + 1 < w.count
            ? lane_index(rows, n, w.tile(k + 1), tile_rows, &next_has_row)
            : -1;
    mbar_wait(w.bar(k), w.parity(k));
    if (has_row && r >= 0 && r < cap)
      bulk_store(pool + (int64_t)r * row_bytes,
                 smem_u32(w.stage(k) + lane * row_bytes), row_bytes);
    bulk_commit();
    bulk_wait_read<1>();  // this lane's store of tile k - 1 has read its row
    __syncwarp();         // ... and so has every lane's
    const int64_t next = k - 1 + kStages;
    if (lane == 0 && k >= 1 && next < w.count) fill(next);
    r = next_r;
    has_row = next_has_row;
  }
  bulk_wait_all();
}

__global__ void noop_kernel() {}

// What a launch takes. The tile geometry follows from the row width
// (mirrored by ops/scatter.py); the grid is persistent: every block the
// card can hold at once, or fewer where the tiles do not fill them.
struct Plan {
  int tile_rows, smem_bytes, blocks_per_sm, sms, grid;
};

// Fills `plan` for n rows of row_bytes and raises the kernel's dynamic
// shared-memory limit to what the launch needs.
template <typename Kernel>
cudaError_t make_plan(Kernel kernel, int64_t n, int64_t row_bytes, Plan* plan) {
  if (n <= 0 || row_bytes <= 0 || row_bytes % 16) return cudaErrorInvalidValue;
  const int64_t t = kStageBytes / row_bytes;
  plan->tile_rows = (int)(t < 1 ? 1 : t > kMaxTileRows ? kMaxTileRows : t);
  const int64_t smem =
      (int64_t)kWarps * kStages * (plan->tile_rows * row_bytes + 8);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  plan->smem_bytes = (int)smem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem_bytes);
  if (err != cudaSuccess) return err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&plan->sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &plan->blocks_per_sm, kernel, kThreads, plan->smem_bytes)) !=
      cudaSuccess)
    return err;
  if (plan->blocks_per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int64_t tiles = (n + plan->tile_rows - 1) / plan->tile_rows;
  const int64_t blocks = (tiles + kWarps - 1) / kWarps;
  const int64_t resident = (int64_t)plan->blocks_per_sm * plan->sms;
  plan->grid = (int)(blocks < resident ? blocks : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out[i] = pool[rows[i]] (zeros where rows[i] is outside [0, cap)).
// pool [cap, row_bytes], out [n, row_bytes]; row_bytes % 16 == 0 and both
// pointers 16-byte aligned (checked by the Python wrapper). n > 0.
int mt_gather_rows(const void* pool, int64_t cap, const int32_t* rows,
                   int64_t n, void* out, int64_t row_bytes, void* stream) {
  Plan plan;
  cudaError_t err = make_plan(gather_rows_kernel, n, row_bytes, &plan);
  if (err != cudaSuccess) return (int)err;
  gather_rows_kernel<<<plan.grid, kThreads, plan.smem_bytes,
                       (cudaStream_t)stream>>>(
      (const unsigned char*)pool, cap, rows, n, (unsigned char*)out,
      (int)row_bytes, plan.tile_rows);
  return (int)cudaGetLastError();
}

// pool[rows[i]] = values[i] for rows[i] in [0, cap), in place; rows unique.
int mt_scatter_rows(void* pool, int64_t cap, const int32_t* rows,
                    const void* values, int64_t n, int64_t row_bytes,
                    void* stream) {
  Plan plan;
  cudaError_t err = make_plan(scatter_rows_kernel, n, row_bytes, &plan);
  if (err != cudaSuccess) return (int)err;
  scatter_rows_kernel<<<plan.grid, kThreads, plan.smem_bytes,
                        (cudaStream_t)stream>>>(
      (unsigned char*)pool, cap, rows, (const unsigned char*)values, n,
      (int)row_bytes, plan.tile_rows);
  return (int)cudaGetLastError();
}

// What the two launches above use for n rows of row_bytes: geometry[0..7] =
// warps a block, stages, tile_rows, shared-memory bytes, K1's grid, K2's
// grid, blocks an SM (K1's kernel), the card's SMs.
int mt_rows_geometry(int64_t n, int64_t row_bytes, int64_t* geometry) {
  Plan k1, k2;
  cudaError_t err = make_plan(gather_rows_kernel, n, row_bytes, &k1);
  if (err != cudaSuccess) return (int)err;
  if ((err = make_plan(scatter_rows_kernel, n, row_bytes, &k2)) != cudaSuccess)
    return (int)err;
  const int64_t values[8] = {kWarps,  kStages, k1.tile_rows,     k1.smem_bytes,
                             k1.grid, k2.grid, k1.blocks_per_sm, k1.sms};
  for (int i = 0; i < 8; ++i) geometry[i] = values[i];
  return 0;
}

// An empty kernel: what a launch costs between two events.
int mt_noop(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"

// Stochastic rounding f32 -> bf16 (K3), for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by monolith_tpu_torch/ops/rounding.py,
// launched on the caller's stream.
//
// Replaces monolith_tpu/ops/rounding.py::_stochastic_round_bf16_pallas, the
// TPU kernel that draws its noise from the on-core PRNG. Semantics are the
// JAX package's portable version (_stochastic_round_bf16_jnp): add 16 random
// bits to the f32 bit pattern (wrapping), keep the high 16 bits. The noise
// comes from Philox4x32-10 (Random123's constants) written into the kernel:
// element i takes word (i % 4) of Philox4x32-10 at counter
// (g mod 2^32, g >> 32, 0, 0), g = i / 4, key (seed mod 2^32, seed >> 32),
// and uses that word's high 16 bits. The plain PyTorch version in
// rounding.py computes the same mapping, so the two agree bit for bit.
//
// A pure elementwise pass, bound by bytes: 4 B read and 2 B written per
// element (37.7 MB at [49152, 128], ~11 us at 3.35 TB/s). One Philox call
// (~40 integer multiplies) serves four elements: under the bound, but a
// good part of it on the card's integer pipes, so a thread has loads in
// flight while it multiplies. Design:
//
// - Work unit: an octet, 8 elements = two Philox groups, read as two
//   16-byte loads and written as ONE 16-byte store of 8 bf16. Loads and
//   stores carry the streaming hint (ld/st.global.cs): nothing is read
//   again.
// - Persistent grid of kThreads-thread blocks: at most the card's SMs
//   times the blocks one SM holds (cudaOccupancyMaxActiveBlocksPerMulti-
//   processor; 2 of 512 threads at 48 registers), queried once per device
//   and process and cached. Below that, one block per kThreads octets, so
//   that a small n spreads one octet a thread over as many SMs as it
//   fills ([49152, 17]: 204 blocks, one pass), and n below
//   kThreads x 8 + 8 elements is one block.
// - A trip: with T threads in the grid, thread i (warp-contiguous
//   numbering) takes octets first + j * T, j < kOctets, first = i on the
//   first trip and kOctets * T further on each next. A warp's loads each
//   cover one contiguous kilobyte; every thread carries the same number of
//   octets, give or take one. It issues all 2 x kOctets loads (4 x 16 B)
//   before its first Philox chain, so their latency hides behind the
//   integer work of its 2 x kOctets chains, then packs and stores.
// - The tail, the n % 8 elements after the last whole octet (at most two
//   groups), is rounded element by element by the grid's last thread.
//
// kOctets and kThreads were chosen by timing variants in turns on one H100
// (bench_rounding.py): 4 octets a trip (71 registers, 3 blocks of 256 an
// SM) ran 3-5% slower; 128 and 256 threads, and loads and stores without
// the streaming hint, within 4%. Every variant, the earlier one-group design
// and PyTorch's own f32 -> bf16 conversion of the same bytes took the same
// time within a few percent: what is left between this kernel and its
// bound is the card's, not the kernel's (PERF.md).
//
// mt_stochastic_round_bf16_geometry reports the launch for n (mirrored by
// ops/rounding.py::grid_size for the CPU tests); an empty kernel on the same
// grid (mt_stochastic_round_bf16_empty) measures what a launch of that grid
// costs with no work in it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 512;   // threads a block
constexpr int kOctets = 2;      // octets a thread takes a trip
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four words of group g (elements 4g .. 4g + 3).
__device__ __forceinline__ uint4 group_words(int64_t g, uint2 key) {
  return philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)((uint64_t)g >> 32), 0u, 0u), key);
}

// bf16 bits of v rounded up with probability (low 16 bits of v) / 2^16.
__device__ __forceinline__ uint32_t round_one(float v, uint32_t word) {
  return (__float_as_uint(v) + (word >> 16)) >> 16;
}

// round_one of a and of b, packed a low, b high: one byte permute takes
// the high halves of the two sums.
__device__ __forceinline__ uint32_t round_two(float a, uint32_t wa, float b,
                                              uint32_t wb) {
  return __byte_perm(__float_as_uint(a) + (wa >> 16),
                     __float_as_uint(b) + (wb >> 16), 0x7632);
}

__device__ __forceinline__ uint32_t word_of(uint4 w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

__global__ void __launch_bounds__(kThreads)
    stochastic_round_bf16_kernel(const float4* __restrict__ x, int64_t n,
                                 uint2 key, uint4* __restrict__ out) {
  const int64_t octets = n / 8;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  const int64_t me = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t first = me; first < octets; first += threads * kOctets) {
    float4 v[2 * kOctets];
#pragma unroll
    for (int j = 0; j < kOctets; ++j) {
      const int64_t o = first + j * threads;
      if (o < octets) {
        v[2 * j] = __ldcs(x + 2 * o);
        v[2 * j + 1] = __ldcs(x + 2 * o + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < kOctets; ++j) {
      const int64_t o = first + j * threads;
      if (o < octets) {
        const uint4 a = group_words(2 * o, key);
        const uint4 b = group_words(2 * o + 1, key);
        const float4 va = v[2 * j], vb = v[2 * j + 1];
        __stcs(out + o, make_uint4(round_two(va.x, a.x, va.y, a.y),
                                   round_two(va.z, a.z, va.w, a.w),
                                   round_two(vb.x, b.x, vb.y, b.y),
                                   round_two(vb.z, b.z, vb.w, b.w)));
      }
    }
  }
  const int64_t tail = octets * 8;
  if (tail < n && me == threads - 1) {
    const float* xs = reinterpret_cast<const float*>(x);
    uint16_t* os = reinterpret_cast<uint16_t*>(out);
    const uint4 w0 = group_words(tail / 4, key);
    const uint4 w1 = group_words(tail / 4 + 1, key);
    for (int j = 0; tail + j < n; ++j)
      os[tail + j] = (uint16_t)round_one(xs[tail + j],
                                         word_of(j < 4 ? w0 : w1, j & 3));
  }
}

__global__ void stochastic_round_bf16_empty_kernel() {}

// The card's SMs and this kernel's resident blocks an SM, by device: 0
// until the first launch on that device asks the runtime.
std::atomic<int> g_sms[kMaxDevices];
std::atomic<int> g_blocks_per_sm[kMaxDevices];

cudaError_t card_of_current_device(int* sms, int* blocks_per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached) {
    *blocks_per_sm = g_blocks_per_sm[device].load(std::memory_order_acquire);
    if (*blocks_per_sm > 0) {
      *sms = g_sms[device].load(std::memory_order_relaxed);
      return cudaSuccess;
    }
  }
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           blocks_per_sm, stochastic_round_bf16_kernel, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (*blocks_per_sm < 1) return cudaErrorLaunchOutOfResources;
  if (cached) {
    g_sms[device].store(*sms, std::memory_order_relaxed);
    g_blocks_per_sm[device].store(*blocks_per_sm, std::memory_order_release);
  }
  return cudaSuccess;
}

// Blocks for n elements: one per kThreads octets, at least one (the tail),
// at most what the card holds at once.
int64_t grid_size(int64_t n, int sms, int blocks_per_sm) {
  int64_t blocks = (n / 8 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  const int64_t resident = (int64_t)sms * blocks_per_sm;
  return blocks < resident ? blocks : resident;
}

cudaError_t plan(int64_t n, int64_t* grid) {
  if (n <= 0) return cudaErrorInvalidValue;
  int sms = 0, blocks_per_sm = 0;
  const cudaError_t err = card_of_current_device(&sms, &blocks_per_sm);
  if (err != cudaSuccess) return err;
  *grid = grid_size(n, sms, blocks_per_sm);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out[i] = stochastically rounded bf16 bits of x[i], i < n (n > 0). x and
// out are 16-byte aligned (checked by the Python wrapper).
int mt_stochastic_round_bf16(const float* x, int64_t n, uint64_t seed,
                             void* out, void* stream) {
  int64_t grid = 0;
  const cudaError_t err = plan(n, &grid);
  if (err != cudaSuccess) return (int)err;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  stochastic_round_bf16_kernel<<<(unsigned int)grid, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), n, key, (uint4*)out);
  return (int)cudaGetLastError();
}

// The launch for n elements: geometry[0..4] = threads a block, octets a
// thread a trip, blocks an SM, the card's SMs, the grid.
int mt_stochastic_round_bf16_geometry(int64_t n, int64_t* geometry) {
  int64_t grid = 0;
  cudaError_t err = plan(n, &grid);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, blocks_per_sm = 0;
  if ((err = card_of_current_device(&sms, &blocks_per_sm)) != cudaSuccess)
    return (int)err;
  const int64_t values[5] = {kThreads, kOctets, blocks_per_sm, sms, grid};
  for (int i = 0; i < 5; ++i) geometry[i] = values[i];
  return 0;
}

// An empty kernel on the grid that n elements launch: the floor of that
// launch's time.
int mt_stochastic_round_bf16_empty(int64_t n, void* stream) {
  int64_t grid = 0;
  const cudaError_t err = plan(n, &grid);
  if (err != cudaSuccess) return (int)err;
  stochastic_round_bf16_empty_kernel<<<(unsigned int)grid, kThreads, 0,
                                       (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"

// The earlier design of K3, kept only as a timing baseline: chip_smoke.py's
// K3 phase and bench_rounding.py build it as librounding_one_group and time
// it beside csrc/rounding.cu on the same inputs. No path of the port
// launches it. Below this note it is the earlier csrc/rounding.cu,
// unchanged: one thread a group of four elements, one block of 256 threads
// per 256 groups.
//
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
// element (37.7 MB at [49152, 128], ~11 us at 3.35 TB/s); one Philox call
// (~40 integer operations) serves four elements, far under the integer
// rate. Design: one thread per group of four elements, a 16-byte float4
// load, one Philox call, one 8-byte store of four bf16; a grid-stride loop
// covers any n, and the ragged tail (n % 4) is done element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

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

// bf16 bits of v rounded up with probability (low 16 bits of v) / 2^16.
__device__ __forceinline__ uint32_t round_one(float v, uint32_t word) {
  return (__float_as_uint(v) + (word >> 16)) >> 16;
}

__global__ void stochastic_round_bf16_kernel(const float* __restrict__ x,
                                             int64_t n, uint2 key,
                                             uint16_t* __restrict__ out) {
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)g, (uint32_t)(g >> 32), 0u, 0u), key);
    const int64_t i = g * 4;
    if (i + 4 <= n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      uint2 packed;
      packed.x = round_one(v.x, w.x) | (round_one(v.y, w.y) << 16);
      packed.y = round_one(v.z, w.z) | (round_one(v.w, w.w) << 16);
      reinterpret_cast<uint2*>(out)[g] = packed;
    } else {
      for (int j = 0; i + j < n; ++j) {
        const uint32_t word = j == 0 ? w.x : j == 1 ? w.y : w.z;  // j < 3
        out[i + j] = (uint16_t)round_one(x[i + j], word);
      }
    }
  }
}

}  // namespace

extern "C" {

// out[i] = stochastically rounded bf16 bits of x[i], i < n (n > 0). x is
// 16-byte aligned and out 8-byte aligned (checked by the Python wrapper).
int mt_stochastic_round_bf16(const float* x, int64_t n, uint64_t seed,
                             void* out, void* stream) {
  const int64_t groups = (n + 3) / 4;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  stochastic_round_bf16_kernel<<<(unsigned int)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(x, n, key,
                                                         (uint16_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

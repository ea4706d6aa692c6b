"""Stochastic rounding of f32 values to bf16 (K3).

`stochastic_round_bf16` replaces monolith_tpu/ops/rounding.py::
_stochastic_round_bf16_pallas, the TPU kernel behind the JAX package's
`stochastic_round_bf16`. A bf16 pool with `stochastic_rounding` narrows the
optimized f32 rows through it, so that updates smaller than a bf16 ulp
still accumulate in expectation. The arithmetic is the JAX package's
portable version (`_stochastic_round_bf16_jnp`):

    bits = bitcast_u32(x) + noise16        (wrapping u32 addition)
    out  = bf16(bitcast_f32(bits & 0xFFFF0000))

which rounds up with probability equal to the dropped low 16 bits over
2^16; the truncation is exact.

The noise is Philox4x32-10 (Random123: multipliers 0xD2511F53 and
0xCD9E8D57, key increments 0x9E3779B9 and 0xBB67AE85), counter based, so
kernel and plain version draw the same bits. For a flat element index i,
with g = i // 4:

    counter = (g mod 2^32, g >> 32, 0, 0)
    key     = (seed mod 2^32, seed >> 32)
    noise16[i] = word (i % 4) of Philox4x32-10(counter, key) >> 16

(the high 16 bits of the word). The TPU's bits differ; the JAX and port
versions are held against each other by handing them the same noise
(`round_with_noise`), and by distribution.

On the card the wrapper launches csrc/rounding.cu (sm_90a, built at first
use by build.py, bound through ctypes). It is bytes-bound: 6 B per
element, 37.7 MB at [49152, 128], ~11 us at 3.35 TB/s. Its design (the
note in the source): a persistent grid of `THREADS`-thread blocks, as many
as the card holds at once (queried once per device and process) or fewer
where n does not fill them; each thread takes `OCTETS` octets (8 elements,
two Philox groups) a trip, issues all their 16-byte loads before its first
Philox chain and writes each octet with one 16-byte store; the grid's last
thread rounds the n % 8 elements of the tail. `grid_size` and
`octet_walk` mirror that arithmetic for the CPU tests; `kernel_geometry`
reads the C side's, for the card tests to hold the two equal. On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises, never falls back. `stochastic_round_bf16.launches`
counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from monolith_tpu_torch import build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def declare_rounding(lib: ctypes.CDLL) -> None:
    """The C interface of K3, which every build of it keeps."""
    vp = ctypes.c_void_p
    lib.mt_stochastic_round_bf16.restype = ctypes.c_int
    lib.mt_stochastic_round_bf16.argtypes = [vp, ctypes.c_int64,
                                             ctypes.c_uint64, vp, vp]


def _declare(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    declare_rounding(lib)
    lib.mt_stochastic_round_bf16_geometry.restype = ctypes.c_int
    lib.mt_stochastic_round_bf16_geometry.argtypes = [i64,
                                                      ctypes.POINTER(i64)]
    lib.mt_stochastic_round_bf16_empty.restype = ctypes.c_int
    lib.mt_stochastic_round_bf16_empty.argtypes = [i64, ctypes.c_void_p]


def kernel_library() -> ctypes.CDLL:
    """The built K3 library (compiled with nvcc at first use)."""
    return build.load_kernel_library("rounding", _declare)


#: csrc/rounding.cu's constants: threads a block, octets (8 elements) a
#: thread takes a trip
THREADS, OCTETS = 512, 2


def grid_size(n: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of the persistent grid for n elements: one per THREADS whole
    octets, at least one (the tail), at most what the card holds at
    once."""
    return min(max(-(-(n // 8) // THREADS), 1), blocks_per_sm * sms)


def octet_walk(n: int, grid: int) -> Iterator[Tuple[int, int, int, int]]:
    """The kernel's walk: (block, thread, trip, octet) for every whole
    octet, in each thread's order. With T = grid * THREADS threads, thread
    t of block b (number i = b * THREADS + t) takes, on trip k, the
    octets (k * OCTETS + j) * T + i (j < OCTETS) below n // 8. The n % 8
    elements after the last octet go to the grid's last thread."""
    octets, total = n // 8, grid * THREADS
    for block in range(grid):
        for thread in range(THREADS):
            i = block * THREADS + thread
            for trip, first in enumerate(range(i, octets, total * OCTETS)):
                for j in range(OCTETS):
                    if first + j * total < octets:
                        yield block, thread, trip, first + j * total


def kernel_geometry(n: int) -> Dict[str, int]:
    """What csrc/rounding.cu launches for n elements on the current card
    (needs the card)."""
    out = (ctypes.c_int64 * 5)()
    err = kernel_library().mt_stochastic_round_bf16_geometry(n, out)
    if err:
        raise RuntimeError(f"mt_stochastic_round_bf16_geometry failed (CUDA "
                           f"error {err})")
    keys = ("threads", "octets", "blocks_per_sm", "sms", "grid")
    return dict(zip(keys, out))


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of a * b, for a 32-bit constant `a` and an
    int64 tensor `b` of values in [0, 2^32). The product is formed from
    16-bit halves of `a`, so no intermediate leaves int64's range."""
    t = b * (a & 0xFFFF)                 # < 2^48
    s = b * (a >> 16) + (t >> 16)        # < 2^49; a*b = s*2^16 + t%2^16
    return s >> 16, ((s & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(counter: Sequence[torch.Tensor],
                  key: Tuple[int, int]) -> List[torch.Tensor]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: four counter
    words (broadcastable), two key words (ints); returns the four output
    words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64) (got {seed})")
    return seed


def philox_noise16(seed: int, n: int, device=None) -> torch.Tensor:
    """The 16-bit noise of elements 0..n-1 for `seed` (mapping in the
    module docstring): int64 [n] of values in [0, 2^16)."""
    seed = _check_seed(seed)
    g = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10((g & _MASK32, g >> 32, zero, zero),
                          (seed & _MASK32, seed >> 32))
    return torch.stack(words, dim=1).reshape(-1)[:n] >> 16


def round_with_noise(x: torch.Tensor, noise16: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 given each element's 16-bit noise (same number of
    elements as x, values in [0, 2^16)): the JAX package's arithmetic,
    bit for bit. Done in int64, where the wrapping u32 add is a mask."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_with_noise: x must be float32 (got "
                         f"{x.dtype})")
    bits = x.contiguous().view(torch.int32).reshape(-1).long() & _MASK32
    high = ((bits + noise16.reshape(-1).long()) & _MASK32) >> 16
    high = torch.where(high >= 1 << 15, high - (1 << 16), high)  # as int16
    return high.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def stochastic_round_bf16_plain(x: torch.Tensor, seed: int) -> torch.Tensor:
    """K3's plain version: Philox noise, then round_with_noise."""
    return round_with_noise(x, philox_noise16(seed, x.numel(), x.device))


def launch(lib: ctypes.CDLL, x: torch.Tensor, seed: int,
           out: torch.Tensor) -> None:
    """Launch `lib`'s K3 on checked tensors (x f32 and out bf16 on one
    card, contiguous, 16-byte aligned, x.numel() > 0; bench_rounding.py
    passes another build's library here); raises if the launch is
    refused."""
    with torch.cuda.device(x.device):
        err = lib.mt_stochastic_round_bf16(
            x.data_ptr(), x.numel(), seed, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stochastic_round_bf16: kernel launch failed "
                           f"(CUDA error {err})")


def stochastic_round_bf16(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Stochastically round f32 `x` (any shape) to bf16 with the Philox
    noise of `seed` (an int in [0, 2^64))."""
    if x.dtype != torch.float32:
        raise ValueError(f"stochastic_round_bf16: x must be float32 (got "
                         f"{x.dtype})")
    seed = _check_seed(seed)
    if x.device.type == "cpu":
        return stochastic_round_bf16_plain(x, seed)
    if x.device.type != "cuda":
        raise ValueError(f"stochastic_round_bf16: x must be on a CUDA device "
                         f"or on the CPU (got {x.device})")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("stochastic_round_bf16: x must be contiguous and "
                         "16-byte aligned")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if x.numel() == 0:
        return out
    if out.data_ptr() % 16:  # the kernel writes 16-byte vectors
        raise RuntimeError("stochastic_round_bf16: the output is not 16-byte "
                           "aligned")
    launch(kernel_library(), x, seed, out)
    stochastic_round_bf16.launches += 1
    return out


stochastic_round_bf16.launches = 0

"""K3's launch arithmetic on the CPU: the persistent grid and the octet walk
that ops/rounding.py mirrors from csrc/rounding.cu (the card tests hold the
mirror equal to the C side), and a replay of the kernel's arithmetic along
that walk (an octet's two Philox groups packed into one 16-byte store by
the byte permute, the tail element by element) that must give the plain
version bit for bit.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from monolith_tpu_torch.ops import rounding

torch.set_num_threads(1)

CARDS = [(1, 1), (1, 2), (4, 132), (8, 132)]     # (blocks an SM, SMs)


@pytest.mark.parametrize("blocks_per_sm,sms", CARDS)
@pytest.mark.parametrize("n", [1, 7, 8, 221, 4095, 4096, 4104, 835_584,
                               6_291_456, 17_285_120])
def test_grid_is_persistent_and_sized_by_n(n, blocks_per_sm, sms):
    grid = rounding.grid_size(n, blocks_per_sm, sms)
    assert 1 <= grid <= blocks_per_sm * sms
    if grid < blocks_per_sm * sms:
        # not capped by the card: an octet for each thread, and every
        # block has one (but the tail's block, for n < 8)
        assert grid * rounding.THREADS >= n // 8
        assert (grid - 1) * rounding.THREADS < max(n // 8, 1)


def test_one_block_below_a_blocks_share():
    """n below one block's octets (4096 elements and the tail) is one
    block, one pass."""
    per_block = rounding.THREADS * 8
    for n in (1, 13 * 17, per_block - 1, per_block + 7):
        assert rounding.grid_size(n, 2, 132) == 1
    assert rounding.grid_size(per_block + 8, 2, 132) == 2
    # [49152, 17]: 104,448 octets, one for each thread of 204 blocks
    assert rounding.grid_size(49152 * 17, 2, 132) == 49152 * 17 // per_block
    # [49152, 128] fills the card: 264 blocks, 5-6 octets a thread
    assert rounding.grid_size(49152 * 128, 2, 132) == 264


@pytest.mark.parametrize("n,grid", [(1, 1), (7, 1), (9, 1), (221, 1),
                                    (4104, 2), (70_001, 1), (70_001, 3),
                                    (70_001, 9)])
def test_walk_takes_every_octet_once(n, grid):
    walk = list(rounding.octet_walk(n, grid))
    counts = Counter(o for *_, o in walk)
    assert sorted(counts) == list(range(n // 8))
    assert set(counts.values()) <= {1}
    per_trip = grid * rounding.THREADS * rounding.OCTETS
    trips = max((t for _, _, t, _ in walk), default=0) + 1
    assert trips == max(-(-(n // 8) // per_trip), 1)
    # balanced: no thread takes more than one octet over any other
    per_thread = Counter((b, t) for b, t, _, _ in walk)
    if per_thread:
        assert max(per_thread.values()) - min(per_thread.values()) <= 1


def test_a_warps_loads_cover_contiguous_spans():
    """On every trip, octet slot j of a warp's 32 threads is 32 octets in
    a row: each load instruction reads one contiguous kilobyte."""
    grid = 2
    total = grid * rounding.THREADS
    by_slot = {}
    for block, thread, trip, o in rounding.octet_walk(
            3 * total * rounding.OCTETS * 8, grid):
        j = o // total % rounding.OCTETS
        by_slot.setdefault((block, trip, thread // 32, j), []).append(o)
    assert len(by_slot) == grid * 3 * rounding.THREADS // 32 * rounding.OCTETS
    for octets in by_slot.values():
        assert octets == list(range(octets[0], octets[0] + 32))


def _replay(x: torch.Tensor, seed: int, grid: int) -> torch.Tensor:
    """csrc/rounding.cu's arithmetic along octet_walk: each octet's groups
    2o and 2o + 1, words to elements in order, two sums packed into one u32
    by __byte_perm(a, b, 0x7632) (a's high half low, b's high half high),
    four u32 stored little-endian; then the tail by the last thread."""
    n = x.numel()
    bits = x.reshape(-1).view(torch.int32).long() & 0xFFFFFFFF
    key = (seed & 0xFFFFFFFF, seed >> 32)
    out = np.full(n, -1, dtype=np.int64)
    walk = [o for *_, o in rounding.octet_walk(n, grid)]
    if walk:
        o = torch.tensor(walk, dtype=torch.int64)
        zero = torch.zeros((), dtype=torch.int64)
        words = []
        for g in (2 * o, 2 * o + 1):
            words += rounding.philox4x32_10(
                (g & 0xFFFFFFFF, g >> 32, zero, zero), key)
        w = torch.stack(words, dim=1)                      # [octets, 8]
        e = 8 * o[:, None] + torch.arange(8)
        sums = (bits[e] + (w >> 16)) & 0xFFFFFFFF
        packed = (sums[:, 0::2] >> 16) | (sums[:, 1::2] & 0xFFFF0000)
        halves = torch.stack([packed & 0xFFFF, packed >> 16], dim=2)
        out[e.reshape(-1).numpy()] = halves.reshape(-1).numpy()
    tail = (n // 8) * 8
    if tail < n:
        g = torch.tensor([tail // 4, tail // 4 + 1])
        zero = torch.zeros((), dtype=torch.int64)
        w = torch.stack(rounding.philox4x32_10(
            (g & 0xFFFFFFFF, g >> 32, zero, zero), key), dim=1).reshape(-1)
        for j in range(n - tail):
            out[tail + j] = ((int(bits[tail + j]) + (int(w[j]) >> 16))
                             & 0xFFFFFFFF) >> 16
    assert (out >= 0).all(), "an element no thread wrote"
    return torch.from_numpy(out.astype(np.uint16).view(np.int16))


@pytest.mark.parametrize("seed", [0x0000_0001_2345_6789,
                                  0xFFFF_FFFE_2345_6789])
@pytest.mark.parametrize("n,grid", [(1, 1), (3, 1), (4, 1), (5, 1), (7, 1),
                                    (8, 1), (9, 1), (221, 1), (4104, 2),
                                    (20_007, 1), (20_007, 5)])
def test_replayed_kernel_equals_the_plain_version(n, grid, seed):
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.normal(size=n) * 100).astype(np.float32))
    want = rounding.stochastic_round_bf16_plain(x, seed).view(torch.int16)
    assert torch.equal(_replay(x, seed, grid), want)

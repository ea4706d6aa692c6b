"""Plain PyTorch pieces that the reference models share: a dense tower,
the combiners, the loss, and glorot-uniform weights made from a seed.

The reference is written from the model's published description (DeepFM,
Guo et al. 2017) and the configuration files, in float32. It imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F


def mlp_shapes(prefix: str, widths: Sequence[int]) -> Dict[str, Tuple]:
    """Parameter shapes of a dense tower `widths[0] -> ... -> widths[-1]`:
    `<prefix>.dense_<i>.weight` [out, in] and `.bias` [out]."""
    out = {}
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"{prefix}.dense_{i}.weight"] = (n_out, n_in)
        out[f"{prefix}.dense_{i}.bias"] = (n_out,)
    return out


def mlp(x: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
        layers: int) -> torch.Tensor:
    """x W^T + b for each layer, ReLU after every layer but the last."""
    for i in range(layers):
        x = x @ params[f"{prefix}.dense_{i}.weight"].t() \
            + params[f"{prefix}.dense_{i}.bias"]
        if i < layers - 1:
            x = torch.relu(x)
    return x


def mlp_flops(widths: Sequence[int]) -> int:
    """Multiply-adds of one example through a dense tower, as FLOPs."""
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def combine(emb: torch.Tensor, valid: torch.Tensor, combiner: str
            ) -> torch.Tensor:
    """emb [B, L, D] with zero rows where `valid` [B, L] is False."""
    if combiner == "sum":
        return emb.sum(dim=1)
    raise ValueError(f"unknown combiner {combiner!r}")


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy."""
    return F.binary_cross_entropy_with_logits(logits, labels)


def dense_weights(shapes: Dict[str, Tuple], seed: int, device
                  ) -> Dict[str, torch.Tensor]:
    """Glorot-uniform kernels and zero biases for `shapes`, from ONE draw
    on `device` seeded from `seed`; the same seed gives the same weights on
    one kind of device."""
    names = sorted(shapes)
    kernels = [n for n in names if len(shapes[n]) == 2]
    total = sum(math.prod(shapes[n]) for n in kernels)
    g = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + 17) % (1 << 63))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for n in names:
        shape = shapes[n]
        if len(shape) != 2:
            out[n] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        k = math.prod(shape)
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[n] = ((u[off:off + k] * 2 - 1) * limit).reshape(shape)
        off += k
    return out


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """Float32 products with TF32 on or off inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old

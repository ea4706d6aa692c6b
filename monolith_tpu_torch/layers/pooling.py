"""Pooling over [B, T, D] sequences with optional [B, T] masks (ref
layers/pooling.py SumPooling / AvgPooling / MaxPooling), the port of the
JAX package's layers/pooling.py: the average divides by max(mask sum, 1);
the max over masked positions reads -inf, and a row with none reads 0."""

from __future__ import annotations

from typing import Optional

import torch


def sum_pooling(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    if mask is not None:
        x = x * mask[..., None]
    return x.sum(dim=1)


def avg_pooling(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    if mask is None:
        return x.mean(dim=1)
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return (x * mask[..., None]).sum(dim=1) / denom


def max_pooling(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    if mask is not None:
        x = torch.where(mask[..., None] > 0, x,
                        torch.full((), float("-inf"), dtype=x.dtype,
                                   device=x.device))
    out = x.max(dim=1).values
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


class SumPooling:
    def __call__(self, x, mask=None):
        return sum_pooling(x, mask)


class AvgPooling:
    def __call__(self, x, mask=None):
        return avg_pooling(x, mask)


class MaxPooling:
    def __call__(self, x, mask=None):
        return max_pooling(x, mask)

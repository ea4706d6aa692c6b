"""Layers that draw random numbers, and the stream they draw from.

A drawing layer (DCN's dropout, SNR's hard-concrete gate) takes its
numbers from an explicit `torch.Generator` on its device, `draw_gen`,
never from torch's global generator: whoever drives the module hands one
generator to every drawing layer (`set_generator`) and seeds it. The
`Trainer` seeds its generator from (config.seed, step) before each step,
so a restored trainer draws what the original would have drawn. A
drawing layer that is asked to draw without a generator raises.

`dropout` is flax's `nn.Dropout`: keep each value with probability
`keep_prob` and scale it by 1 / keep_prob (keep_prob = 1 - rate as flax
computes it); rate 0 is the identity and draws nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Drawing(nn.Module):
    """Base of the layers that draw; `draw_gen` is set by `set_generator`."""

    draw_gen: Optional[torch.Generator] = None

    def draw_generator(self) -> torch.Generator:
        if self.draw_gen is None:
            raise RuntimeError(
                f"{type(self).__name__} draws random numbers and has no "
                f"generator: hand it one with layers.draws.set_generator")
        return self.draw_gen


def set_generator(module: nn.Module, generator: torch.Generator) -> int:
    """Give `generator` to every drawing layer of `module`; returns how
    many there are."""
    n = 0
    for m in module.modules():
        if isinstance(m, Drawing):
            m.draw_gen = generator
            n += 1
    return n


def uniform(shape, generator: torch.Generator, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=, maxval=)`'s arithmetic on
    torch's stream: u * (maxval - minval) + minval, at least minval."""
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return torch.clamp(u * (maxval - minval) + minval, min=minval)


def dropout(x: torch.Tensor, keep_prob: float,
            generator: torch.Generator) -> torch.Tensor:
    rate = 1.0 - keep_prob
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep_prob == 0.0:
        return torch.zeros_like(x)
    mask = uniform(x.shape, generator, x.device) < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))

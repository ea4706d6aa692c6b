"""flax's parameter initializers for the port's layers.

The JAX layers draw their parameters with flax's initializers: a bare
`nn.Dense` with `lecun_normal` (a normal truncated at two standard
deviations, variance 1 / fan_in), `self.param(...)` with `glorot_normal`
(truncated the same way, variance 2 / (fan_in + fan_out)),
`glorot_uniform` or a plain normal; biases are zeros. Here the same
distributions draw from a torch generator, so a port module matches its
JAX counterpart in distribution (mean, standard deviation, bounds), not bit
for bit: carried weights come through `convert.py`.

Shapes are given in flax's layout, `[..., in, out]`: fan_in is
`shape[-2]` and fan_out `shape[-1]`, each times the product of the leading
axes, as flax's `variance_scaling` computes them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def _fans(shape: Sequence[int]):
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _truncated_normal(shape, variance: float, generator) -> torch.Tensor:
    std = math.sqrt(variance) / _TRUNCATED_STD
    return nn.init.trunc_normal_(torch.empty(tuple(shape)), 0.0, std,
                                 -2.0 * std, 2.0 * std, generator=generator)


def lecun_normal(shape, generator=None) -> torch.Tensor:
    fan_in, _ = _fans(shape)
    return _truncated_normal(shape, 1.0 / fan_in, generator)


def glorot_normal(shape, generator=None) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    return _truncated_normal(shape, 2.0 / (fan_in + fan_out), generator)


def glorot_uniform(shape, generator=None) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape)).uniform_(-limit, limit,
                                              generator=generator)


def normal(shape, std: float, generator=None) -> torch.Tensor:
    return torch.empty(tuple(shape)).normal_(0.0, std, generator=generator)


def zeros(shape, generator=None) -> torch.Tensor:
    return torch.zeros(tuple(shape))


def param(init, shape, generator=None) -> nn.Parameter:
    """A parameter of flax's layout `shape`, drawn by `init`."""
    return nn.Parameter(init(shape, generator))


def dense(in_dim: int, out_dim: int,
          generator: Optional[torch.Generator] = None,
          use_bias: bool = True, kernel_init=lecun_normal) -> nn.Linear:
    """flax's `nn.Dense(out_dim)` on inputs of width `in_dim`: the kernel
    drawn by `kernel_init` (lecun_normal, flax's default), the bias zero.
    The weight is `nn.Linear`'s [out, in], the kernel transposed, which is
    how `convert.py` carries it."""
    layer = nn.Linear(in_dim, out_dim, bias=use_bias)
    with torch.no_grad():
        layer.weight.copy_(kernel_init((in_dim, out_dim), generator).T)
        if use_bias:
            layer.bias.zero_()
    return layer

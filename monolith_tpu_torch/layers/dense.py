"""Dense layer with optional kernel (weight) normalization (ref
layers/dense.py Dense with allow_kernel_norm) and AddBias (ref
layers/add_bias.py), the port of the JAX package's layers/dense.py.

The kernel is glorot-uniform and the bias zero, as in the JAX layer. It is
held as `weight`, `nn.Linear`'s [out, in] (the flax kernel transposed, which
is how `convert.py` carries it); `kernel_norm` [out] and `bias` [out] cross
by name. With `allow_kernel_norm` each output's column of the kernel is
divided by its L2 norm (sqrt(sum of squares + 1e-12)) and, with
`kernel_norm_trainable`, scaled by the learned `kernel_norm` (ones at
init).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from monolith_tpu_torch.layers import initializers as init


class Dense(nn.Module):
    def __init__(self, in_dim: int, features: int, use_bias: bool = True,
                 allow_kernel_norm: bool = False,
                 kernel_norm_trainable: bool = True,
                 activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.allow_kernel_norm = allow_kernel_norm
        self.activation = activation
        self.weight = nn.Parameter(
            init.glorot_uniform((in_dim, features), generator).T.contiguous())
        self.kernel_norm = (nn.Parameter(torch.ones(features))
                            if allow_kernel_norm and kernel_norm_trainable
                            else None)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.allow_kernel_norm:
            # weight normalization: direction from the kernel, magnitude
            # learned
            w = w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True) + 1e-12)
            if self.kernel_norm is not None:
                w = w * self.kernel_norm[:, None]
        y = F.linear(x, w, self.bias)
        return y if self.activation is None else self.activation(y)


class AddBias(nn.Module):
    """x + `bias` ([dim], zeros at init)."""

    def __init__(self, dim: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias

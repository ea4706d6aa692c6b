"""Dense tower MLP (ref: layers/mlp.py MLP) as an nn.Module.

Layers are `dense_{i}` (`nn.Linear`, weight [out, in]), matching the flax
module's parameter names so converted weights land by name. Kernels are
glorot-uniform and biases zero, as in flax; this is not `nn.Linear`'s
default init.

`compute_dtype=torch.bfloat16` runs the layers as flax's
`Dense(dtype=bfloat16)` does: input, kernel and bias cast to bf16, the
product rounded to bf16, the bias added in bf16, activations kept in bf16,
and the output upcast to f32. Parameters, their gradients and the
optimizer stay f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Module):
    """Dense + ReLU layers; the last layer has no activation."""

    def __init__(self, input_dim: int, output_dims: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = len(output_dims)
        self.compute_dtype = compute_dtype
        fan_in = input_dim
        for i, dim in enumerate(output_dims):
            layer = nn.Linear(fan_in, dim)
            limit = math.sqrt(6.0 / (fan_in + dim))
            with torch.no_grad():
                layer.weight.uniform_(-limit, limit, generator=generator)
                layer.bias.zero_()
            setattr(self, f"dense_{i}", layer)
            fan_in = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(dt)
        for i in range(self.num_layers):
            layer = getattr(self, f"dense_{i}")
            if dt is None:
                x = layer(x)
            else:
                x = F.linear(x, layer.weight.to(dt)) + layer.bias.to(dt)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x.float()

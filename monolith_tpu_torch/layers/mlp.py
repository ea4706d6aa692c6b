"""Dense tower MLP (ref: layers/mlp.py MLP) as an nn.Module.

Layers are `dense_{i}` (`nn.Linear`, weight [out, in]), matching the flax
module's parameter names so converted weights land by name. Kernels are
glorot-uniform and biases zero, as in flax; this is not `nn.Linear`'s
default init.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    """Dense + ReLU layers; the last layer has no activation."""

    def __init__(self, input_dim: int, output_dims: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = len(output_dims)
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
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x

"""Dense tower MLP (ref: layers/mlp.py MLP) as an nn.Module.

Layers are `dense_{i}` (`nn.Linear`, weight [out, in]), matching the flax
module's parameter names so converted weights land by name. Kernels are
glorot-uniform and biases zero, as in flax; this is not `nn.Linear`'s
default init. `activation` is a name of `layers/activations.py` or a
function (ReLU by default); it follows every layer but the last, and the
last too with `activate_last`. `use_bias=False` drops the biases.

`compute_dtype=torch.bfloat16` runs the layers as flax's
`Dense(dtype=bfloat16)` does: input, kernel and bias cast to bf16, the
product rounded to bf16, the bias added in bf16, activations kept in bf16,
and the output upcast to f32. Parameters, their gradients and the
optimizer stay f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from monolith_tpu_torch.layers import activations


class MLP(nn.Module):
    """Dense layers, each followed by the activation but the last (unless
    `activate_last`)."""

    def __init__(self, input_dim: int, output_dims: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 activation: Union[str, Callable] = "relu",
                 activate_last: bool = False, use_bias: bool = True):
        super().__init__()
        self.num_layers = len(output_dims)
        self.compute_dtype = compute_dtype
        self.activation = activations.get(activation)
        self.activate_last = activate_last
        fan_in = input_dim
        for i, dim in enumerate(output_dims):
            layer = nn.Linear(fan_in, dim, bias=use_bias)
            limit = math.sqrt(6.0 / (fan_in + dim))
            with torch.no_grad():
                layer.weight.uniform_(-limit, limit, generator=generator)
                if use_bias:
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
                x = F.linear(x, layer.weight.to(dt))
                if layer.bias is not None:
                    x = x + layer.bias.to(dt)
            if i < self.num_layers - 1 or self.activate_last:
                x = self.activation(x)
        return x.float()

"""LHUC tower (ref layers/lhuc.py:37 LHUCTower), the port of the JAX
package's layers/lhuc.py: each dense layer's output is scaled elementwise
by a gate in [0, 2] (2 * sigmoid of an MLP) driven by personalization
features (Learning Hidden Unit Contributions).

Layers are `dense_{i}` (flax's `nn.Dense`: lecun-normal kernel, zero bias)
and gates `lhuc_{i}` (an MLP of `lhuc_hidden` then the layer's width), the
flax module's names."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.layers import activations
from monolith_tpu_torch.layers import initializers as init
from monolith_tpu_torch.layers.mlp import MLP


class LHUCTower(nn.Module):
    """forward(dense_input [B, in_dim], lhuc_input [B, lhuc_dim] or None
    for the dense input itself) -> [B, output_dims[-1]]. The activation
    follows every layer but the last, before its gate."""

    def __init__(self, in_dim: int, output_dims: Sequence[int],
                 lhuc_dim: Optional[int] = None,
                 lhuc_hidden: Sequence[int] = (32,),
                 activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = len(output_dims)
        self.act = activations.get(activation)
        lhuc_dim = in_dim if lhuc_dim is None else lhuc_dim
        fan_in = in_dim
        for i, dim in enumerate(output_dims):
            setattr(self, f"dense_{i}", init.dense(fan_in, dim, generator))
            setattr(self, f"lhuc_{i}", MLP(lhuc_dim, (*lhuc_hidden, dim),
                                           generator=generator))
            fan_in = dim

    def forward(self, dense_input: torch.Tensor,
                lhuc_input: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lhuc_input is None:
            lhuc_input = dense_input
        x = dense_input
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:
                x = self.act(x)
            gate = getattr(self, f"lhuc_{i}")(lhuc_input)
            x = x * 2.0 * torch.sigmoid(gate)
        return x

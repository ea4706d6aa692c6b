"""Feature-cross layers: DCN's CrossNet and xDeepFM's CIN (ref layers/dcn.py
and layers/cin.py), the port of the JAX package's layers/cross.py, and
DCN V2's low-rank cross (Wang et al., arXiv:2008.13535), which the JAX
package does not have."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from monolith_tpu_torch.layers import initializers as init


class CrossNet(nn.Module):
    """Deep & Cross network cross layers over [B, D]:
    x_{l+1} = x0 * (W x_l + b) + x_l, with Dense layers `cross_{i}`."""

    def __init__(self, dim: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"cross_{i}", init.dense(dim, dim, generator))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"cross_{i}")(x) + x
        return x


class LowRankCross(nn.Module):
    """DCN V2's low-rank cross layers over [B, D], as MLPerf's DLRM-DCNv2
    runs them: x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, with `v_{l}`
    [rank, D] and `w_{l}` [D, rank] glorot-uniform and `b_{l}` [D] zero."""

    def __init__(self, dim: int, num_layers: int = 3, rank: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"v_{i}", init.param(init.glorot_uniform,
                                               (rank, dim), generator))
            setattr(self, f"w_{i}", init.param(init.glorot_uniform,
                                               (dim, rank), generator))
            setattr(self, f"b_{i}", init.param(init.zeros, (dim,)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            low = F.linear(x, getattr(self, f"v_{i}"))
            x = x0 * F.linear(low, getattr(self, f"w_{i}"),
                              getattr(self, f"b_{i}")) + x
        return x


class CIN(nn.Module):
    """Compressed Interaction Network (xDeepFM): field-wise outer products
    compressed by learned [Fk*F0, h] maps `cin_w_{i}` (glorot-uniform);
    input [B, F, D] -> pooled [B, sum(layer_sizes)]."""

    def __init__(self, num_fields: int, layer_sizes: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = len(layer_sizes)
        fk = num_fields
        for i, h in enumerate(layer_sizes):
            setattr(self, f"cin_w_{i}", init.param(
                init.glorot_uniform, (fk * num_fields, h), generator))
            fk = h

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        b, _, d = x0.shape
        xk, outs = x0, []
        for i in range(self.num_layers):
            # pairwise products along fields: [B, Fk*F0, D]
            z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(b, -1, d)
            xk = torch.einsum("bzd,zh->bhd", z, getattr(self, f"cin_w_{i}"))
            outs.append(xk.sum(dim=-1))  # [B, h]
        return torch.cat(outs, dim=-1)

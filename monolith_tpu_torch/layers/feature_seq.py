"""Sequence-feature layers (ref: layers/feature_seq.py). The port carries
DIN in the form the multislot model uses; DIEN and DMR_U2I are not ported
yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from monolith_tpu_torch.layers.mlp import MLP


class DIN(nn.Module):
    """Deep Interest Network attention in the JAX layer's default form
    (mode "sum", no decay): one weight per history item from the MLP
    `dense_tower` (units (T, 1), f32) over [q, k, q-k, q*k]; masked items
    weigh 0; the weighted keys are summed to [B, H]."""

    def __init__(self, key_dim: int, seq_len: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_tower = MLP(4 * key_dim, (seq_len, 1), generator=generator)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, h = keys.shape
        q = queries[:, None, :].expand(b, t, h)
        din_all = torch.cat([q, keys, q - keys, q * keys], dim=-1)
        w = self.dense_tower(din_all)  # [B, T, 1]
        if mask is not None:
            w = torch.where(mask[..., None] > 0, w,
                            torch.zeros((), dtype=w.dtype, device=w.device))
        return torch.einsum("btl,bth->bh", w, keys)

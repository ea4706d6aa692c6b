"""Feature-transform layers (ref layers/feature_trans.py): AutoInt (:31),
iRazor (:97) and SeNet (:232), the port of the JAX package's
layers/feature_trans.py."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.layers import initializers as init
from monolith_tpu_torch.layers.mlp import MLP


class AutoInt(nn.Module):
    """Self-attention feature interaction: `layer_num` rounds of
    softmax(X X^T) X over the field axis. Input and output [B, F, D]
    ([B, F*D] with `flatten`). No parameters."""

    def __init__(self, layer_num: int = 1, flatten: bool = False):
        super().__init__()
        self.layer_num, self.flatten = layer_num, flatten

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        x = embeds
        for _ in range(self.layer_num):
            attn = torch.softmax(torch.einsum("bfd,bgd->bfg", x, x), dim=-1)
            x = torch.einsum("bfg,bgd->bfd", attn, x)
        return x.reshape(x.shape[0], -1) if self.flatten else x


class SeNet(nn.Module):
    """Squeeze-and-excitation over fields: squeeze = per-field mean,
    excitation = the 2-layer MLP `excitation` (ReLU after both layers) ->
    per-field scale. [B, F, D] -> [B, F*D] ([B, F, D] without `flatten`)."""

    def __init__(self, num_fields: int, reduction_ratio: int = 4,
                 flatten: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.flatten = flatten
        hidden = max(1, num_fields // reduction_ratio)
        self.excitation = MLP(num_fields, (hidden, num_fields),
                              generator=generator, activate_last=True)

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        b, f, d = embeds.shape
        scale = self.excitation(embeds.mean(dim=2))  # [B, F]
        out = embeds * scale[:, :, None]
        return out.reshape(b, f * d) if self.flatten else out


class iRazor(nn.Module):
    """Soft embedding-dimension search: each field learns a softmax
    (`nas_logits`, zeros at first) over nested dimension prefixes
    `nas_space`; the soft mask scales the embedding columns, and
    `penalty_weight * sum(mask)` is returned as the auxiliary loss.
    Input [B, F, D] -> (out [B, F, D], nas_loss)."""

    def __init__(self, num_fields: int,
                 nas_space: Sequence[int] = (0, 1, 2, 4, 8),
                 temperature: float = 1.0, penalty_weight: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nas_space = tuple(nas_space)
        self.temperature, self.penalty_weight = temperature, penalty_weight
        self.nas_logits = init.param(init.zeros,
                                     (num_fields, len(self.nas_space)),
                                     generator)

    def forward(self, embeds: torch.Tensor):
        d = embeds.shape[-1]
        assert max(self.nas_space) == d, "nas_space max must equal emb dim"
        w = torch.softmax(self.nas_logits / self.temperature, dim=1)  # [F, C]
        # choice c enables the first nas_space[c] dims
        cols = torch.arange(d, device=embeds.device)[None, :]
        space = torch.tensor(self.nas_space, device=embeds.device)[:, None]
        soft_mask = w @ (cols < space).to(torch.float32)  # [F, D]
        out = embeds * soft_mask[None, :, :]
        return out, self.penalty_weight * soft_mask.sum()

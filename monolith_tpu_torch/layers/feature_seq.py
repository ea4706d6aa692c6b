"""Sequence-feature layers (ref layers/feature_seq.py): DIN (:33), DIEN
(:154) and DMR_U2I (:267), the port of the JAX package's
layers/feature_seq.py. Sequences are the bounded "firstn" combiner's
[B, T, D]; masks are [B, T], nonzero where a step is real."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.layers import initializers as init
from monolith_tpu_torch.layers.agru import AUGRU, GRU
from monolith_tpu_torch.layers.mlp import MLP


class DIN(nn.Module):
    """Deep Interest Network attention: one weight per history item from
    the MLP `dense_tower` (units `hidden_units`, by default (T, 1)) over
    [q, k, q-k, q*k]; `decay` divides it by sqrt(H); masked items weigh 0.
    Mode "sum" pools the weighted keys to [B, H]; any other mode returns
    them, [B, T, H]."""

    def __init__(self, key_dim: int, seq_len: int,
                 generator: Optional[torch.Generator] = None,
                 hidden_units: Optional[Sequence[int]] = None,
                 mode: str = "sum", decay: bool = False):
        super().__init__()
        units = tuple(hidden_units) if hidden_units else (seq_len, 1)
        assert units[-1] == 1
        self.mode, self.decay = mode, decay
        self.dense_tower = MLP(4 * key_dim, units, generator=generator)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, h = keys.shape
        q = queries[:, None, :].expand(b, t, h)
        din_all = torch.cat([q, keys, q - keys, q * keys], dim=-1)
        w = self.dense_tower(din_all)  # [B, T, 1]
        if self.decay:
            w = w / (h ** 0.5)
        if mask is not None:
            w = torch.where(mask[..., None] > 0, w,
                            torch.zeros((), dtype=w.dtype, device=w.device))
        if self.mode == "sum":
            return torch.einsum("btl,bth->bh", w, keys)
        return keys * w


class DIEN(nn.Module):
    """Deep Interest Evolution Network: a GRU over the history
    (`interest_gru`), attention of the projected query (`query_proj`)
    against its outputs, by dot product ("dot") or else by the MLP
    `att_mlp` over [q, o, q-o, q*o]; masked steps get logit -1e9 and so a
    softmax score of 0, under which the AUGRU (`evolution`) carries its
    state through them. Returns the final state [B, num_units]."""

    def __init__(self, query_dim: int, key_dim: int, num_units: int,
                 att_type: str = "dot",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.att_type = att_type
        self.interest_gru = GRU(key_dim, num_units, generator)
        self.query_proj = init.dense(query_dim, num_units, generator)
        if att_type != "dot":
            self.att_mlp = MLP(4 * num_units, (num_units, 1),
                               generator=generator)
        self.evolution = AUGRU(num_units, num_units, generator)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs, _ = self.interest_gru(keys, mask)
        q = self.query_proj(queries)
        if self.att_type == "dot":
            logits = torch.einsum("bu,btu->bt", q, outs)
        else:
            q = q[:, None, :].expand(outs.shape)
            feat = torch.cat([q, outs, q - outs, q * outs], dim=-1)
            logits = self.att_mlp(feat)[..., 0]
        if mask is not None:
            logits = torch.where(mask > 0, logits, torch.full(
                (), -1e9, dtype=logits.dtype, device=logits.device))
        scores = torch.softmax(logits, dim=1)  # [B, T]
        return self.evolution(outs, scores)


class DMR_U2I(nn.Module):
    """Deep Match to Rank user-to-item relevance: positional attention
    pools the user sequence [B, T, U], the Dense `linear` maps it to the
    item space, and the output is its product with the item embedding
    [B, I]."""

    def __init__(self, item_dim: int, seq_dim: int, seq_len: int,
                 cmp_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.emb_weight = init.param(init.glorot_normal, (seq_dim, cmp_dim), g)
        self.pos_emb = init.param(lambda s, g: init.normal(s, 0.02, g),
                                  (seq_len, cmp_dim), g)
        self.bias = init.param(init.zeros, (cmp_dim,), g)
        self.z_weight = init.param(init.glorot_normal, (cmp_dim, 1), g)
        self.linear = init.dense(seq_dim, item_dim, g)

    def forward(self, items: torch.Tensor, user_seq: torch.Tensor
                ) -> torch.Tensor:
        comped = user_seq @ self.emb_weight + self.pos_emb[None] + self.bias
        alpha = torch.softmax(comped @ self.z_weight, dim=1)  # [B, T, 1]
        merged = torch.einsum("btu,btl->bu", user_seq, alpha)
        return self.linear(merged) * items

"""DIN / DIEN sequence CTR tasks, the port of the JAX package's
models/din.py: user and item embeddings and a "firstn" history sequence ->
DIN attention pooling (or DIEN interest evolution) against the item -> the
MLP `tower` -> the CTR logit.

The history's mask is `abs(hist).sum(-1) > 0`, as in JAX: a history id
whose row reads all zeros counts as padding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.spec import (AdmissionConfig,
                                               EvictionConfig, TableSegment,
                                               TableSpec)
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.feature_seq import DIEN, DIN
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.training.task import RecTask


class DINModule(nn.Module):
    """Attention tower: the target item attends over the history."""

    def __init__(self, embedding_dim: int = 16,
                 hidden: Sequence[int] = (128, 64), seq_encoder: str = "din",
                 dien_units: int = 32, history_length: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = embedding_dim
        self.seq_encoder = seq_encoder
        if seq_encoder == "dien":
            self.dien = DIEN(d, d, dien_units, generator=generator)
            interest = dien_units
        else:
            self.din = DIN(d, history_length, generator=generator)
            interest = d
        self.tower = MLP(3 * d + interest, (*hidden, 1), generator=generator)

    def forward(self, pooled: Dict[str, torch.Tensor], batch=None
                ) -> Dict[str, torch.Tensor]:
        user = pooled["user_id"]            # [B, D]
        item = pooled["item_id"]            # [B, D]
        hist = pooled["hist_items"]         # [B, T, D] (firstn combiner)
        mask = (hist.abs().sum(-1) > 0).to(torch.float32)  # [B, T]
        if self.seq_encoder == "dien":
            interest = self.dien(item, hist, mask)
        else:
            interest = self.din(item, hist, mask)
        x = torch.cat([user, item, interest, item * user], dim=-1)
        return {"logits": self.tower(x)[:, 0]}


@dataclasses.dataclass
class DINTask(RecTask):
    """Sequence CTR task: DIN (or DIEN) over a bounded click history."""
    name: str = "din"
    embedding_dim: int = 16
    capacity_per_shard: int = 1 << 17
    lr: float = 1.0
    init_scale: float = 0.3
    accumulator_init: float = 0.01
    admission_threshold: int = 1
    ttl_seconds: int = 0
    history_length: int = 10
    hidden: Sequence[int] = (128, 64)
    seq_encoder: str = "din"

    def tables(self):
        segs = (TableSegment(
            dim=self.embedding_dim,
            optimizer=optimizers.Adagrad(
                learning_rate=self.lr,
                initial_accumulator_value=self.accumulator_init),
            initializer=initializers.RandomUniform(-self.init_scale,
                                                   self.init_scale)),)
        admission = (AdmissionConfig(kind="sliding",
                                     threshold=self.admission_threshold)
                     if self.admission_threshold > 1 else AdmissionConfig())
        return [TableSpec(name="sparse",
                          capacity_per_shard=self.capacity_per_shard,
                          segments=segs, admission=admission,
                          eviction=EvictionConfig(
                              ttl_seconds=self.ttl_seconds))]

    def features(self):
        return [
            FeatureConfig(name="user_id", table="sparse", max_length=1,
                          combiner="sum"),
            FeatureConfig(name="item_id", table="sparse", max_length=1,
                          combiner="sum"),
            FeatureConfig(name="hist_items", table="sparse",
                          max_length=self.history_length, combiner="firstn"),
        ]

    def build_module(self, generator=None):
        return DINModule(embedding_dim=self.embedding_dim,
                         hidden=tuple(self.hidden),
                         seq_encoder=self.seq_encoder,
                         history_length=self.history_length,
                         generator=generator)

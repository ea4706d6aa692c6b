"""DCN demo model, the port of the JAX package's models/dcn.py: the cross
tower (CrossNet, explicit bounded-degree crosses) and the deep tower (an
MLP, activated last) run side by side off the concatenated embeddings; the
Dense `head` gives the logit from [cross | deep]."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.spec import (AdmissionConfig, TableSegment,
                                               TableSpec)
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.cross import CrossNet
from monolith_tpu_torch.layers.initializers import dense
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.training.task import RecTask


class DCNModule(nn.Module):
    """Every feature is one `embedding_dim` field ([B, D])."""

    def __init__(self, feature_names: Sequence[str] = ("user_id", "item_id",
                                                       "hist_items"),
                 cross_layers: int = 3, hidden: Sequence[int] = (128, 64),
                 embedding_dim: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_names = tuple(feature_names)
        width = len(self.feature_names) * embedding_dim
        self.cross = CrossNet(width, cross_layers, generator=generator)
        self.deep = MLP(width, tuple(hidden), generator=generator,
                        activate_last=True)
        self.head = dense(width + hidden[-1], 1, generator)

    def forward(self, pooled: Dict[str, torch.Tensor], batch=None
                ) -> Dict[str, torch.Tensor]:
        x0 = torch.cat([pooled[f] for f in self.feature_names], dim=1)
        logits = self.head(torch.cat([self.cross(x0), self.deep(x0)],
                                     dim=1))[:, 0]
        return {"logits": logits}


@dataclasses.dataclass
class DCNTask(RecTask):
    name: str = "dcn"
    embedding_dim: int = 8
    cross_layers: int = 3
    capacity_per_shard: int = 1 << 16
    lr: float = 1.0
    admission_threshold: int = 1

    def tables(self):
        seg = TableSegment(
            dim=self.embedding_dim,
            optimizer=optimizers.Adagrad(learning_rate=self.lr,
                                         initial_accumulator_value=0.01),
            initializer=initializers.RandomUniform(-0.3, 0.3))
        admission = (AdmissionConfig(kind="sliding",
                                     threshold=self.admission_threshold)
                     if self.admission_threshold > 1 else AdmissionConfig())
        return [TableSpec(name="sparse",
                          capacity_per_shard=self.capacity_per_shard,
                          segments=(seg,), admission=admission)]

    def features(self):
        return [
            FeatureConfig(name="user_id", table="sparse", max_length=1,
                          combiner="sum"),
            FeatureConfig(name="item_id", table="sparse", max_length=1,
                          combiner="sum"),
            FeatureConfig(name="hist_items", table="sparse", max_length=10,
                          combiner="mean"),
        ]

    def build_module(self, generator=None):
        return DCNModule(cross_layers=self.cross_layers,
                         embedding_dim=self.embedding_dim,
                         generator=generator)

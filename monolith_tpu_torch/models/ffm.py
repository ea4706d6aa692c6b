"""FFM demo model (the reference demo task model.py:52 TestFFMModel), the
port of the JAX package's models/ffm.py: per-feature embeddings,
GroupInt/FFM crossing of the user-side with the item-side fields, and the
MLP `head` on [crossed | left | right]."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.spec import (AdmissionConfig, TableSegment,
                                               TableSpec)
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.feature_cross import GroupInt
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.training.task import RecTask


class FFMModule(nn.Module):
    """Every feature is one `embedding_dim` field ([B, D])."""

    def __init__(self, embedding_dim: int = 8,
                 left_features: Sequence[str] = ("user_id",),
                 right_features: Sequence[str] = ("item_id", "hist_items"),
                 hidden: Sequence[int] = (128, 64, 1),
                 interaction_type: str = "multiply",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.left_features = tuple(left_features)
        self.right_features = tuple(right_features)
        f1, f2, d = len(self.left_features), len(self.right_features), \
            embedding_dim
        self.ffm = GroupInt(dim_size=d, interaction_type=interaction_type,
                            generator=generator)
        crossed = f1 * f2 * (d if interaction_type == "multiply" else 1)
        self.head = MLP(crossed + (f1 + f2) * d, tuple(hidden),
                        generator=generator)

    def forward(self, pooled: Dict[str, torch.Tensor], batch=None
                ) -> Dict[str, torch.Tensor]:
        left = torch.cat([pooled[f] for f in self.left_features], dim=1)
        right = torch.cat([pooled[f] for f in self.right_features], dim=1)
        crossed = self.ffm((left, right))
        deep_in = torch.cat([crossed, left, right], dim=1)
        return {"logits": self.head(deep_in)[:, 0]}


@dataclasses.dataclass
class FFMTask(RecTask):
    name: str = "ffm"
    embedding_dim: int = 8
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
        return FFMModule(embedding_dim=self.embedding_dim,
                         generator=generator)

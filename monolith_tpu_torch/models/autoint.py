"""AutoInt demo model, the port of the JAX package's models/autoint.py:
the per-feature embeddings stacked on a field axis [B, F, D]; `layer_num`
rounds of softmax(X X^T) X mix the fields; the flattened result and a deep
MLP (activated last) feed the Dense logit `head`."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.spec import (AdmissionConfig, TableSegment,
                                               TableSpec)
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.feature_trans import AutoInt
from monolith_tpu_torch.layers.initializers import dense
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.training.task import RecTask


class AutoIntModule(nn.Module):
    """Every feature is one `embedding_dim` field ([B, D])."""

    def __init__(self, feature_names: Sequence[str] = ("user_id", "item_id",
                                                       "hist_items"),
                 layer_num: int = 2, hidden: Sequence[int] = (64,),
                 embedding_dim: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_names = tuple(feature_names)
        width = len(self.feature_names) * embedding_dim
        self.autoint = AutoInt(layer_num=layer_num, flatten=True)
        self.deep = MLP(width, tuple(hidden), generator=generator,
                        activate_last=True)
        self.head = dense(width + hidden[-1], 1, generator)

    def forward(self, pooled: Dict[str, torch.Tensor], batch=None
                ) -> Dict[str, torch.Tensor]:
        fields = torch.stack([pooled[f] for f in self.feature_names], dim=1)
        attn = self.autoint(fields)  # [B, F*D]
        deep = self.deep(fields.reshape(fields.shape[0], -1))
        return {"logits": self.head(torch.cat([attn, deep], dim=1))[:, 0]}


@dataclasses.dataclass
class AutoIntTask(RecTask):
    name: str = "autoint"
    embedding_dim: int = 8
    layer_num: int = 2
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
        return AutoIntModule(layer_num=self.layer_num,
                             embedding_dim=self.embedding_dim,
                             generator=generator)

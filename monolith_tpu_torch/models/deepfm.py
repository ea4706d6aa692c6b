"""DeepFM CTR model: first-order terms from a 1-dim table segment, the FM
second-order interaction, and a deep MLP tower; logits = linear + fm + deep.
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
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.ops.interactions import fm_interaction
from monolith_tpu_torch.training.task import RecTask


class DeepFMModule(nn.Module):
    """Dense tower. Pooled embeddings carry [bias(1) | vector(dim)] segments."""

    def __init__(self, embedding_dim: int = 16,
                 hidden: Sequence[int] = (256, 128, 64),
                 feature_names: Sequence[str] = ("user_id", "item_id",
                                                 "hist_items"),
                 dense_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.feature_names = tuple(feature_names)
        self.deep = MLP(len(self.feature_names) * embedding_dim,
                        (*hidden, 1), generator=generator,
                        compute_dtype=dense_dtype)

    def forward(self, pooled: Dict[str, torch.Tensor], batch=None
                ) -> Dict[str, torch.Tensor]:
        d = self.embedding_dim
        bias_terms, vecs = [], []
        for name in self.feature_names:
            e = pooled[name]
            bias_terms.append(e[:, 0])        # 1-dim linear segment
            vecs.append(e[:, 1:1 + d])        # FM/deep vector segment
        stack = torch.stack(vecs, dim=1)      # [B, F, D]
        linear = sum(bias_terms)
        fm = fm_interaction(stack).sum(dim=-1)
        deep = self.deep(stack.reshape(stack.shape[0], -1))[:, 0]
        return {"logits": linear + fm + deep}


@dataclasses.dataclass
class DeepFMTask(RecTask):
    """DeepFM over the synthetic CTR stream. Each table row = [bias segment
    (1, SGD) | vector segment (dim, Adagrad)]. A bf16 pool (`table_dtype`)
    halves the bytes a row; pair it with `stochastic_rounding` so that
    updates below a bf16 ulp accumulate. `dense_dtype=torch.bfloat16` runs
    the tower's matrix products in bf16."""
    name: str = "deepfm"
    embedding_dim: int = 16
    capacity_per_shard: int = 1 << 17
    vector_lr: float = 1.0
    bias_lr: float = 1.0
    init_scale: float = 0.3
    accumulator_init: float = 0.01
    admission_threshold: int = 1
    ttl_seconds: int = 0
    hidden: Sequence[int] = (256, 128, 64)
    table_dtype: torch.dtype = torch.float32
    stochastic_rounding: bool = False
    dense_dtype: Optional[torch.dtype] = None

    def tables(self):
        segs = (
            TableSegment(dim=1,
                         optimizer=optimizers.SGD(learning_rate=self.bias_lr),
                         initializer=initializers.Zeros()),
            TableSegment(dim=self.embedding_dim,
                         optimizer=optimizers.Adagrad(
                             learning_rate=self.vector_lr,
                             initial_accumulator_value=self.accumulator_init),
                         initializer=initializers.RandomUniform(
                             -self.init_scale, self.init_scale)),
        )
        admission = (AdmissionConfig(kind="sliding", threshold=self.admission_threshold)
                     if self.admission_threshold > 1 else AdmissionConfig())
        return [TableSpec(name="sparse", capacity_per_shard=self.capacity_per_shard,
                          segments=segs, admission=admission,
                          eviction=EvictionConfig(ttl_seconds=self.ttl_seconds),
                          dtype=self.table_dtype,
                          stochastic_rounding=self.stochastic_rounding)]

    def features(self):
        return [
            FeatureConfig(name="user_id", table="sparse", max_length=1, combiner="sum"),
            FeatureConfig(name="item_id", table="sparse", max_length=1, combiner="sum"),
            FeatureConfig(name="hist_items", table="sparse", max_length=10, combiner="mean"),
        ]

    def build_module(self, generator=None):
        return DeepFMModule(embedding_dim=self.embedding_dim,
                            hidden=tuple(self.hidden),
                            dense_dtype=self.dense_dtype,
                            generator=generator)

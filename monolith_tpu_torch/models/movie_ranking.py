"""MovieRanking: the reference demo model (ref markdown/demo/demo_model.py:
40-77 MovieRankingModelBase), the port of the JAX package's
models/movie_ranking.py.

One embedding table per sparse feature, a 32-dim slice each, concatenated
and fed to Dense(256, relu) -> Dense(64, relu) -> Dense(1); the dense tower
is trained with Adagrad(0.05) (demo_model.py:64). Embedding slices use the
reference feature.py:86-88 defaults: RandomUniform init and Adagrad with
initial_accumulator_value=1.0.

Heads:
  'ctr'    sigmoid + BCE (the reference EstimatorSpec classification path)
  'rating' the demo's regression head: raw-logit prediction + MSE
           (demo_model.py:62, classification=False).

The tower is the module's `ratings` MLP, so its parameters are
`ratings.dense_<i>.{weight,bias}`, the flax tree's `ratings/dense_<i>/
{kernel,bias}` under `convert.py`'s mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.optimizers.dense import Adagrad
from monolith_tpu_torch.training.task import RecTask


class MovieRankingModule(nn.Module):
    """concat(embeddings) -> MLP tower (ref demo_model.py:52-60)."""

    def __init__(self, embedding_dim: int = 32,
                 hidden: Sequence[int] = (256, 64),
                 feature_names: Sequence[str] = ("user_id", "item_id"),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_names = tuple(feature_names)
        self.ratings = MLP(len(self.feature_names) * embedding_dim,
                           (*hidden, 1), generator=generator)

    def forward(self, pooled: Dict[str, torch.Tensor], batch=None
                ) -> Dict[str, torch.Tensor]:
        x = torch.cat([pooled[n] for n in self.feature_names], dim=1)
        return {"logits": self.ratings(x)[:, 0]}


@dataclasses.dataclass
class MovieRankingTask(RecTask):
    name: str = "movie_ranking"
    embedding_dim: int = 32
    capacity_per_shard: int = 1 << 17
    hidden: Sequence[int] = (256, 64)
    head: str = "ctr"  # 'ctr' (BCE/AUC) | 'rating' (the demo's MSE head)
    embedding_lr: float = 0.05
    dense_lr: float = 0.05
    init_scale: float = 0.05
    # (uid, mov) roles; defaults match the synthetic CTR stream's keys
    feature_names: Sequence[str] = ("user_id", "item_id")

    def tables(self):
        # one table per sparse feature, like the reference demo's
        # create_embedding_feature_column("mov") / ("uid")
        return [
            TableSpec(
                name=f"emb_{f}",
                capacity_per_shard=self.capacity_per_shard,
                segments=(TableSegment(
                    dim=self.embedding_dim,
                    optimizer=optimizers.Adagrad(
                        learning_rate=self.embedding_lr,
                        initial_accumulator_value=1.0),
                    initializer=initializers.RandomUniform(
                        -self.init_scale, self.init_scale)),))
            for f in self.feature_names]

    def features(self):
        return [FeatureConfig(name=f, table=f"emb_{f}", max_length=1,
                              combiner="sum")
                for f in self.feature_names]

    def build_module(self, generator=None):
        return MovieRankingModule(embedding_dim=self.embedding_dim,
                                  hidden=tuple(self.hidden),
                                  feature_names=tuple(self.feature_names),
                                  generator=generator)

    def dense_optimizer(self):
        return Adagrad(learning_rate=self.dense_lr)

    def loss(self, outputs, batch) -> Tuple[torch.Tensor, Dict]:
        if self.head == "rating":
            err = outputs["logits"] - batch["label"]
            return torch.mean(err * err), {}
        return super().loss(outputs, batch)

    def predictions(self, outputs):
        if self.head == "rating":
            return outputs["logits"]
        return super().predictions(outputs)

"""Multi-task CTR/CVR model on MMoE (the reference's multi-head usage:
native_model.py multi-head metrics + the MMoE layer), the port of the JAX
package's models/multitask.py.

The loss is the JAX task's, term for term. Without `batch["labels"]` it
falls back to `batch["label"][:, None]` and still reads column t for every
task t; JAX clamps that static out-of-range index to the last column, so
both heads train against the one label. The port reads the same clamped
column (ROADMAP §3 records it as a behaviour of the reference, not a
fault).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.layers.multi_task import MMoE
from monolith_tpu_torch.losses.losses import bce_with_logits
from monolith_tpu_torch.training.task import RecTask


class MMoEModule(nn.Module):
    """Every feature is one `embedding_dim` field ([B, D])."""

    def __init__(self, embedding_dim: int = 8, num_tasks: int = 2,
                 num_experts: int = 4, expert_dims: Sequence[int] = (64, 32),
                 feature_names: Sequence[str] = ("user_id", "item_id",
                                                 "hist_items"),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_names = tuple(feature_names)
        self.num_tasks = num_tasks
        self.mmoe = MMoE(len(self.feature_names) * embedding_dim, num_tasks,
                         num_experts, tuple(expert_dims), generator=generator)
        for t in range(num_tasks):
            setattr(self, f"head_{t}", MLP(expert_dims[-1], (16, 1),
                                           generator=generator))

    def forward(self, pooled: Dict[str, torch.Tensor], batch=None
                ) -> Dict[str, torch.Tensor]:
        x = torch.cat([pooled[f] for f in self.feature_names], dim=1)
        task_reprs, aux = self.mmoe(x)
        logits = [getattr(self, f"head_{t}")(r)[:, 0]
                  for t, r in enumerate(task_reprs)]
        return {"logits": logits[0], "task_logits": torch.stack(logits, dim=1),
                "aux_loss": aux}


@dataclasses.dataclass
class MMoETask(RecTask):
    """Labels are read from batch["labels"], shape [B, num_tasks]."""
    name: str = "mmoe"
    embedding_dim: int = 8
    num_tasks: int = 2
    capacity_per_shard: int = 1 << 16

    def tables(self):
        seg = TableSegment(
            dim=self.embedding_dim,
            optimizer=optimizers.Adagrad(learning_rate=1.0,
                                         initial_accumulator_value=0.01),
            initializer=initializers.RandomUniform(-0.3, 0.3))
        return [TableSpec(name="sparse",
                          capacity_per_shard=self.capacity_per_shard,
                          segments=(seg,))]

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
        return MMoEModule(embedding_dim=self.embedding_dim,
                          num_tasks=self.num_tasks, generator=generator)

    def loss(self, outputs, batch):
        labels = batch.get("labels")
        if labels is None:
            labels = batch["label"][:, None]
        last = labels.shape[1] - 1   # JAX clamps a static index past it
        per_task = [bce_with_logits(outputs["task_logits"][:, t],
                                    labels[:, min(t, last)])
                    for t in range(outputs["task_logits"].shape[1])]
        loss = sum(per_task) + outputs.get("aux_loss", 0.0)
        return loss, {f"loss_task{t}": l for t, l in enumerate(per_task)}

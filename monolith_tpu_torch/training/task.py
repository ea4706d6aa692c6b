"""User-facing task API: a task declares its embedding tables, sparse
features, the dense nn.Module, the loss and the dense optimizer."""

from __future__ import annotations

import abc
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from monolith_tpu_torch.embedding.spec import TableSpec
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.losses.losses import bce_with_logits
from monolith_tpu_torch.optimizers.dense import Adagrad


class RecTask(abc.ABC):
    """A recommendation training task."""

    name: str = "task"

    @abc.abstractmethod
    def tables(self) -> Sequence[TableSpec]:
        ...

    @abc.abstractmethod
    def features(self) -> Sequence[FeatureConfig]:
        ...

    @abc.abstractmethod
    def build_module(self, generator: Optional[torch.Generator] = None
                     ) -> nn.Module:
        """nn.Module: forward(pooled: dict[str, tensor], batch: dict) ->
        dict with at least {"logits": [B]}. Parameters are drawn from
        `generator`."""
        ...

    def loss(self, outputs: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Default: sigmoid cross-entropy against batch["label"]."""
        return bce_with_logits(outputs["logits"], batch["label"]), {}

    def dense_optimizer(self) -> Adagrad:
        """Dense-tower optimizer: the port's form of optax.adagrad(0.01)."""
        return Adagrad(learning_rate=0.01)

    def predictions(self, outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(outputs["logits"])

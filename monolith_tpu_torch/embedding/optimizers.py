"""Per-row (per-feature-id) embedding optimizers on tensors.

The update is a pure function over the batch of unique rows touched this
step: params [m, d], slots {name: [m, k]}, grads [m, d] -> new params and
slots. Same rules, in the same operation order, as the JAX package's
row optimizers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Slots = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RowOptimizer:
    """Base class. `slot_spec(dim)` declares per-row state columns as
    {name: (width, init_value)}; `apply` is the vectorized update."""

    learning_rate: float = 0.01

    def slot_spec(self, dim: int) -> Dict[str, Tuple[int, float]]:
        return {}

    def apply(self, p: torch.Tensor, slots: Slots, g: torch.Tensor,
              lr: float, step: int) -> Tuple[torch.Tensor, Slots]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SGD(RowOptimizer):
    """ref: sgd_optimizer.cc."""
    learning_rate: float = 0.01

    def apply(self, p, slots, g, lr, step):
        return p - lr * g, slots


@dataclasses.dataclass(frozen=True)
class Adagrad(RowOptimizer):
    """ref: adagrad_optimizer.h. norm += g^2; p -= lr*g/sqrt(norm), with
    norm starting at initial_accumulator_value."""
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1

    def slot_spec(self, dim):
        return {"norm": (dim, self.initial_accumulator_value)}

    def apply(self, p, slots, g, lr, step):
        norm = slots["norm"] + g * g
        return p - lr * g / torch.sqrt(norm), {"norm": norm}

"""Activation registry and the advanced activations (ref
layers/advanced_activations.py), the port of the JAX package's
layers/activations.py.

`get(name)` resolves a name to the function flax uses under it (flax's
`gelu` is the tanh approximation, and so is this one). PReLU and Dice carry
a parameter `alpha` per feature, so they are modules: `get("prelu", dim)`
and `get("dice", dim)` build one for inputs of width `dim`.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn


class PReLU(nn.Module):
    def __init__(self, dim: int, init_alpha: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((dim,), init_alpha))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class Dice(nn.Module):
    """Data-adaptive activation from the DIN paper: p(x)*x + (1-p(x))*alpha*x
    with p(x) = sigmoid(x normalised over the batch by its population
    variance, as `jnp.var`)."""

    def __init__(self, dim: int, epsilon: float = 1e-9):
        super().__init__()
        self.epsilon = epsilon
        self.alpha = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, keepdim=True, correction=0)
        p = torch.sigmoid((x - mean) / torch.sqrt(var + self.epsilon))
        return p * x + (1 - p) * self.alpha * x


def _identity(x):
    return x


_REGISTRY = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "selu": torch.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "swish": F.silu,
    "silu": F.silu,
    "linear": _identity,
    "none": _identity,
}

_MODULES = {"prelu": PReLU, "dice": Dice}


def get(identifier: Union[str, Callable, None],
        dim: Optional[int] = None) -> Callable:
    """Resolve an activation by name (ref advanced_activations.py:102).
    "prelu" and "dice" need the width `dim` of their inputs."""
    if identifier is None:
        return _identity
    if callable(identifier):
        return identifier
    name = identifier.lower()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _MODULES:
        if dim is None:
            raise ValueError(f"activation {identifier!r} has a parameter per "
                             f"feature: pass the width of its inputs")
        return _MODULES[name](dim)
    raise ValueError(f"unknown activation: {identifier}")

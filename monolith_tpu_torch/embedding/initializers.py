"""Row initializers for newly admitted embedding ids.

Initialization is a vectorized device op over the rows admitted this step,
drawn from an explicit `torch.Generator` (Philox on the card). The draws
differ from the JAX package's threefry draws for the same seed: compare
initialized rows by distribution, never element by element.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Initializer:
    def init(self, generator: torch.Generator, shape, device) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Zeros(Initializer):
    def init(self, generator, shape, device):
        return torch.zeros(shape, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class RandomUniform(Initializer):
    minval: float = -0.05
    maxval: float = 0.05

    def init(self, generator, shape, device):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return u * (self.maxval - self.minval) + self.minval

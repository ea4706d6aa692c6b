"""Dense-tower optimizers, in the form of the JAX package's optax chains.

`Adagrad` is `optax.adagrad(learning_rate)` exactly as the installed optax
computes it (scale_by_rss, then scale_by_learning_rate):

    acc += g^2                       (acc starts at 0.1)
    u = g * rsqrt(acc + 1e-7)        (0 where acc == 0)
    p += -learning_rate * u

`torch.optim.Adagrad` differs (accumulator from 0, g / (sqrt(acc) + eps)),
so it is not used. State is a dict name -> accumulator tensor; the update
runs in place on the parameters and the state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch


_INITIAL_ACCUMULATOR = 0.1  # optax.adagrad's defaults
_EPS = 1e-7


@dataclasses.dataclass(frozen=True)
class Adagrad:
    learning_rate: float = 0.01

    def init(self, named_params: Iterable[Tuple[str, torch.Tensor]]
             ) -> Dict[str, torch.Tensor]:
        return {name: torch.full_like(p, _INITIAL_ACCUMULATOR)
                for name, p in named_params}

    @torch.no_grad()
    def update_(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                grads: Dict[str, torch.Tensor],
                state: Dict[str, torch.Tensor]) -> None:
        for name, p in named_params:
            g = grads[name]
            acc = state[name]
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + _EPS),
                              torch.zeros((), dtype=acc.dtype,
                                          device=acc.device))
            p.add_((inv * g) * (-self.learning_rate))

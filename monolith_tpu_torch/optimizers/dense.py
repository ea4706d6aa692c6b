"""Dense-tower optimizers, in the form of the JAX package's optax chains
(ref optimizers/: AdamomOptimizer adamom.py with its fused kernel
cc/kernels/training_ops.cc:78-121, the rmsprop variants, Shampoo
shampoo.py).

Each optimizer has the JAX update rule and defaults, and owns its state:

- `init(named_params)` makes it on the parameters' device;
- `update_(named_params, grads, state)` updates parameters and state in
  place;
- `state_tree(state)` is the state as flax writes the optax state to
  `opt_state.msgpack` (numpy, parameter leaves under their flax names,
  Dense kernels [in, out]), and `load_state_tree(state, tree)` writes such
  a tree back in place.

Flax's trees:

    Adagrad              {"0": {"sum_of_squares": params}, "1": {}}
    Adamom, Adamom v2    {"m": params, "v": params, "c": params}
    RMSprop v2           params
    Shampoo              {"count": int32 scalar, "l_stat", "r_stat",
                          "l_root", "r_root", "diag"}

with a NamedTuple's fields (Adamom's, Shampoo's) in their field order, as
flax writes them (`serialization.Fields`).

`Adagrad` is `optax.adagrad(learning_rate)` exactly as the installed optax
computes it (scale_by_rss, then scale_by_learning_rate):

    acc += g^2                       (acc starts at 0.1)
    u = g * rsqrt(acc + 1e-7)        (0 where acc == 0)
    p += -learning_rate * u

`torch.optim.Adagrad` differs (accumulator from 0, g / (sqrt(acc) + eps)),
so it is not used. Adagrad's and RMSprop v2's state is a dict name ->
tensor of the parameter's shape; Adamom's a dict of three such.

A Dense kernel is `weight` [out, in] in the port, the flax kernel
transposed. Shampoo preconditions in JAX's orientation: it works on the
kernel view (`weight.T`), so its L = g g^T is the flax kernel's [in, in]
statistic, and its whole state is held and written in that orientation.
`torch.linalg.eigh` computes the inverse fourth roots, as
`jnp.linalg.eigh` does in JAX; each optimizer's other arithmetic runs in
the JAX rule's order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from monolith_tpu_torch import convert
from monolith_tpu_torch.serialization import Fields

Named = Iterable[Tuple[str, torch.Tensor]]

_INITIAL_ACCUMULATOR = 0.1  # optax.adagrad's defaults
_EPS = 1e-7


def _zeros(named: Named) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros_like(p) for name, p in named}


@dataclasses.dataclass(frozen=True)
class Adagrad:
    learning_rate: float = 0.01

    def init(self, named_params: Named) -> Dict[str, torch.Tensor]:
        return {name: torch.full_like(p, _INITIAL_ACCUMULATOR)
                for name, p in named_params}

    @torch.no_grad()
    def update_(self, named_params: Named, grads: Dict[str, torch.Tensor],
                state: Dict[str, torch.Tensor]) -> None:
        for name, p in named_params:
            g = grads[name]
            acc = state[name]
            acc.add_(g * g)
            inv = torch.where(acc > 0, torch.rsqrt(acc + _EPS),
                              torch.zeros((), dtype=acc.dtype,
                                          device=acc.device))
            p.add_((inv * g) * (-self.learning_rate))

    def state_tree(self, state) -> Dict:
        return {"0": {"sum_of_squares": convert.dense_tree(state)}, "1": {}}

    def load_state_tree(self, state, tree: Dict) -> None:
        convert.load_dense_tree(state, tree["0"]["sum_of_squares"])


@dataclasses.dataclass(frozen=True)
class Adamom:
    """ref training_ops.cc:78 ApplyAdamom:
      g' = g + wd * var; m = mom * m + (1 - mom) * g'; v = ada * v + g'^2;
      c = ada * c + 1; var -= lr * m * rsqrt(v / c + eps)
    `v2` is ApplyAdamomV2 (:101): var -= lr * m / (sqrt(v / c) + eps)."""
    learning_rate: float = 5e-6
    ada_decay: float = 0.9999
    mom_decay: float = 0.99
    epsilon: float = 1e-6
    weight_decay: float = 0.0
    v2: bool = False

    def init(self, named_params: Named) -> Dict[str, Dict]:
        named = list(named_params)
        return {k: _zeros(named) for k in ("m", "v", "c")}

    @torch.no_grad()
    def update_(self, named_params: Named, grads: Dict[str, torch.Tensor],
                state: Dict[str, Dict]) -> None:
        ada, mom = self.ada_decay, self.mom_decay
        for name, p in named_params:
            g = grads[name] + self.weight_decay * p
            m = state["m"][name].copy_(mom * state["m"][name] + (1 - mom) * g)
            v = state["v"][name].copy_(ada * state["v"][name] + g * g)
            c = state["c"][name].copy_(ada * state["c"][name] + 1.0)
            if self.v2:
                upd = -self.learning_rate * m / (torch.sqrt(v / c)
                                                 + self.epsilon)
            else:
                upd = -self.learning_rate * m * torch.rsqrt(v / c
                                                            + self.epsilon)
            p.add_(upd)

    def state_tree(self, state) -> Dict:
        return Fields((k, convert.dense_tree(state[k]))
                      for k in ("m", "v", "c"))

    def load_state_tree(self, state, tree: Dict) -> None:
        for k in ("m", "v", "c"):
            convert.load_dense_tree(state[k], tree[k])


@dataclasses.dataclass(frozen=True)
class RMSpropV2:
    """Dense counterpart of the per-id RMSpropV2 (rmsprop_optimizer.cc:127):
    dx = g + wd * var; n = mom * n + dx^2; var -= lr * dx / (sqrt(n) + 1)."""
    learning_rate: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, named_params: Named) -> Dict[str, torch.Tensor]:
        return _zeros(named_params)

    @torch.no_grad()
    def update_(self, named_params: Named, grads: Dict[str, torch.Tensor],
                state: Dict[str, torch.Tensor]) -> None:
        for name, p in named_params:
            dx = grads[name] + self.weight_decay * p
            n = state[name].copy_(self.momentum * state[name] + dx * dx)
            p.add_(-self.learning_rate * dx / (torch.sqrt(n) + 1.0))

    def state_tree(self, state) -> Dict:
        return convert.dense_tree(state)

    def load_state_tree(self, state, tree: Dict) -> None:
        convert.load_dense_tree(state, tree)


_SHAMPOO_TREES = ("l_stat", "r_stat", "l_root", "r_root", "diag")


def _kernel_view(name: str, t: torch.Tensor) -> torch.Tensor:
    """A parameter in flax's orientation: a Dense `weight` as its kernel."""
    return t.T if name.split(".")[-1] == "weight" else t


@dataclasses.dataclass(frozen=True)
class Shampoo:
    """Second-order preconditioning of matrices (2-D, at most 2048 a side):
    L^{-1/4} G R^{-1/4}, the roots recomputed by eigendecomposition when
    count % update_preconditioner_every == 1, the step's magnitude grafted
    from Adagrad (diag accumulator without an initial value); every other
    parameter takes the Adagrad step -lr * g / (sqrt(diag) + eps).
    `count` is kept on the host (the trees write it as an int32 scalar),
    so the recompute is decided without reading the device."""
    learning_rate: float = 0.01
    block_size: int = 128
    beta2: float = 1.0
    epsilon: float = 1e-6
    update_preconditioner_every: int = 10
    graft_to: str = "adagrad"

    @staticmethod
    def _is_mat(p: torch.Tensor) -> bool:
        return p.ndim == 2 and p.shape[0] <= 2048 and p.shape[1] <= 2048

    def init(self, named_params: Named) -> Dict:
        state = {"count": 0, **{k: {} for k in _SHAMPOO_TREES}}
        for name, p in named_params:
            p = _kernel_view(name, p)
            scalar = p.new_zeros(())
            for side, n in (("l", 0), ("r", 1)):
                state[f"{side}_stat"][name] = (p.new_zeros((p.shape[n],) * 2)
                                               if self._is_mat(p) else scalar)
                state[f"{side}_root"][name] = (
                    torch.eye(p.shape[n], dtype=p.dtype, device=p.device)
                    if self._is_mat(p) else scalar.clone())
            state["diag"][name] = p.new_zeros(p.shape)
        return state

    def _root(self, stat: torch.Tensor) -> torch.Tensor:
        eye = torch.eye(stat.shape[0], dtype=stat.dtype, device=stat.device)
        w, u = torch.linalg.eigh(stat + self.epsilon * eye)
        w = torch.clamp(w, min=self.epsilon)
        return (u * (w ** -0.25)) @ u.T

    @torch.no_grad()
    def update_(self, named_params: Named, grads: Dict[str, torch.Tensor],
                state: Dict) -> None:
        state["count"] += 1
        recompute = state["count"] % self.update_preconditioner_every == 1
        for name, p in named_params:
            g = _kernel_view(name, grads[name])
            ls, rs = state["l_stat"][name], state["r_stat"][name]
            mat = g.ndim == 2 and ls.ndim == 2
            if mat:
                for s, gg in ((ls, g @ g.T), (rs, g.T @ g)):
                    s.copy_(self.beta2 * s + gg if self.beta2 < 1.0
                            else s + gg)
            d = state["diag"][name].add_(g * g)
            graft = -self.learning_rate * g / (torch.sqrt(d) + self.epsilon)
            if not mat:
                p.add_(_kernel_view(name, graft))
                continue
            if recompute:
                state["l_root"][name].copy_(self._root(ls))
                state["r_root"][name].copy_(self._root(rs))
            precond = state["l_root"][name] @ g @ state["r_root"][name]
            pn = torch.linalg.norm(precond) + 1e-30
            gn = torch.linalg.norm(graft)
            p.add_(_kernel_view(name, -(precond / pn) * gn))

    def state_tree(self, state) -> Dict:
        return Fields([("count", np.asarray(state["count"], np.int32))]
                      + [(k, convert.dense_tree(state[k], transpose=False))
                         for k in _SHAMPOO_TREES])

    def load_state_tree(self, state, tree: Dict) -> None:
        for k in _SHAMPOO_TREES:
            convert.load_dense_tree(state[k], tree[k], transpose=False)
        state["count"] = int(tree["count"])


# the JAX package's names (monolith_tpu.optimizers), with its defaults
adamom = Adamom
adamom_v2 = functools.partial(Adamom, v2=True)
rmsprop_v2 = RMSpropV2
shampoo = Shampoo

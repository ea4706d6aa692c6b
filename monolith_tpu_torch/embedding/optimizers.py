"""Per-row (per-feature-id) embedding optimizers on tensors.

The update is a pure function over the batch of unique rows touched this
step: params [m, d], slots {name: [m, k]}, grads [m, d] -> new params and
slots. Same rules, in the same operation order, as the JAX package's
row optimizers, with the same class, field and slot names and slot init
values, so that `table._layout` packs the same columns at the same offsets
and a pool converts one to one whatever its optimizers.

`lr` is a Python float and `step` a Python int (the host knows both; the
JAX package traces them). A weight-decay term is added only where its
factor is non-zero: `g + 0.0 * p` has g's value, and skipping it saves
launches on the card.
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


def _decayed(g: torch.Tensor, p: torch.Tensor, factor: float) -> torch.Tensor:
    """g + factor * p (coupled weight decay)."""
    return g + factor * p if factor != 0.0 else g


@dataclasses.dataclass(frozen=True)
class Adagrad(RowOptimizer):
    """ref: adagrad_optimizer.h. norm += g^2; p -= lr*g/sqrt(norm), with
    norm starting at initial_accumulator_value."""
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1
    weight_decay_factor: float = 0.0

    def slot_spec(self, dim):
        return {"norm": (dim, self.initial_accumulator_value)}

    def apply(self, p, slots, g, lr, step):
        g = _decayed(g, p, self.weight_decay_factor)
        norm = slots["norm"] + g * g
        return p - lr * g / torch.sqrt(norm), {"norm": norm}


@dataclasses.dataclass(frozen=True)
class DynamicWdAdagrad(RowOptimizer):
    """Adagrad with optional decoupled weight decay (ref:
    dynamic_wd_avx_utils.h BaselineDynamicWdAdagradOptimize)."""
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1
    weight_decay_factor: float = 0.0
    decouple_weight_decay: bool = False

    def slot_spec(self, dim):
        return {"norm": (dim, self.initial_accumulator_value)}

    def apply(self, p, slots, g, lr, step):
        if not self.decouple_weight_decay:
            g = _decayed(g, p, self.weight_decay_factor)
        norm = slots["norm"] + g * g
        update = lr * g / torch.sqrt(norm)
        if self.decouple_weight_decay:
            update = update + lr * self.weight_decay_factor * p
        return p - update, {"norm": norm}


@dataclasses.dataclass(frozen=True)
class Adadelta(RowOptimizer):
    """ref: adadelta_optimizer.cc. Both roots are sqrt(acc + epsilon)."""
    learning_rate: float = 0.01
    weight_decay_factor: float = 0.0
    averaging_ratio: float = 0.9
    epsilon: float = 0.01

    def slot_spec(self, dim):
        return {"accum": (dim, 0.0), "accum_update": (dim, 0.0)}

    def apply(self, p, slots, g, lr, step):
        rho = self.averaging_ratio
        g = _decayed(g, p, self.weight_decay_factor)
        accum = rho * slots["accum"] + (1 - rho) * g * g
        update = (g * torch.sqrt(slots["accum_update"] + self.epsilon)
                  / torch.sqrt(accum + self.epsilon))
        accum_update = rho * slots["accum_update"] + (1 - rho) * update * update
        return p - lr * update, {"accum": accum, "accum_update": accum_update}


def _adam_moments(opt, p, slots, g, lr):
    """What Adam and AMSGrad share: the bias-corrected rate from the
    per-row beta powers (per-entry state, as in the reference), the decayed
    gradient, both moments and the numerator."""
    b1p, b2p = slots["beta1_power"], slots["beta2_power"]
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    g = _decayed(g, p, opt.weight_decay_factor)
    m = slots["m"] + (g - slots["m"]) * (1 - opt.beta1)
    v = slots["v"] + (g * g - slots["v"]) * (1 - opt.beta2)
    num = g * (1 - opt.beta1) + opt.beta1 * m if opt.use_nesterov else m
    return lr_t, m, v, num, {"beta1_power": b1p * opt.beta1,
                             "beta2_power": b2p * opt.beta2}


@dataclasses.dataclass(frozen=True)
class Adam(RowOptimizer):
    """ref: adam_optimizer.cc:57-84. The root is sqrt(v) + epsilon."""
    learning_rate: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay_factor: float = 0.0
    use_nesterov: bool = False
    epsilon: float = 0.01

    def slot_spec(self, dim):
        return {"m": (dim, 0.0), "v": (dim, 0.0),
                "beta1_power": (1, self.beta1), "beta2_power": (1, self.beta2)}

    def apply(self, p, slots, g, lr, step):
        lr_t, m, v, num, powers = _adam_moments(self, p, slots, g, lr)
        p = p - num * lr_t / (torch.sqrt(v) + self.epsilon)
        return p, {"m": m, "v": v, **powers}


@dataclasses.dataclass(frozen=True)
class AMSGrad(RowOptimizer):
    """ref: amsgrad_optimizer.cc: Adam over the running maximum of v."""
    learning_rate: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay_factor: float = 0.0
    use_nesterov: bool = False
    epsilon: float = 0.01

    def slot_spec(self, dim):
        return {"m": (dim, 0.0), "v": (dim, 0.0), "vhat": (dim, 0.0),
                "beta1_power": (1, self.beta1), "beta2_power": (1, self.beta2)}

    def apply(self, p, slots, g, lr, step):
        lr_t, m, v, num, powers = _adam_moments(self, p, slots, g, lr)
        vhat = torch.maximum(slots["vhat"], v)
        p = p - num * lr_t / (torch.sqrt(vhat) + self.epsilon)
        return p, {"m": m, "v": v, "vhat": vhat, **powers}


@dataclasses.dataclass(frozen=True)
class Momentum(RowOptimizer):
    """ref: momentum_optimizer.cc."""
    learning_rate: float = 0.01
    weight_decay_factor: float = 0.0
    use_nesterov: bool = False
    momentum: float = 0.9

    def slot_spec(self, dim):
        return {"n": (dim, 0.0)}

    def apply(self, p, slots, g, lr, step):
        g = _decayed(g, p, self.weight_decay_factor)
        n = self.momentum * slots["n"] + lr * g
        if self.use_nesterov:
            p = p - (lr * g + self.momentum * n)
        else:
            p = p - n
        return p, {"n": n}


@dataclasses.dataclass(frozen=True)
class MovingAverage(RowOptimizer):
    """EMA "optimizer": value <- momentum*value + (1-momentum)*grad, where
    the incoming "grad" is the new observation (ref:
    moving_average_optimizer.cc:43-49)."""
    learning_rate: float = 1.0  # unused
    momentum: float = 0.9

    def apply(self, p, slots, g, lr, step):
        return self.momentum * p + (1 - self.momentum) * g, slots


def _rmsprop(opt, p, slots, g, lr, g2_weight: float):
    dx = _decayed(g, p, opt.weight_decay_factor)
    g2 = dx * dx if g2_weight == 1.0 else g2_weight * dx * dx
    n = opt.momentum * slots["n"] + g2
    return p - lr * dx / (torch.sqrt(n) + 1.0), {"n": n}


@dataclasses.dataclass(frozen=True)
class RMSprop(RowOptimizer):
    """ref: rmsprop_optimizer.cc:50-67: n <- mom*n + (1-mom)*dx^2,
    w -= lr*dx/(sqrt(n)+1)."""
    learning_rate: float = 0.01
    weight_decay_factor: float = 0.0
    momentum: float = 0.9

    def slot_spec(self, dim):
        return {"n": (dim, 0.0)}

    def apply(self, p, slots, g, lr, step):
        return _rmsprop(self, p, slots, g, lr, 1 - self.momentum)


@dataclasses.dataclass(frozen=True)
class RMSpropV2(RowOptimizer):
    """ref: rmsprop_optimizer.cc:127-146: accumulates the full dx^2 (no
    1-mom factor), i.e. a momentum-decayed adagrad."""
    learning_rate: float = 0.01
    weight_decay_factor: float = 0.0
    momentum: float = 0.9

    def slot_spec(self, dim):
        return {"n": (dim, 0.0)}

    def apply(self, p, slots, g, lr, step):
        return _rmsprop(self, p, slots, g, lr, 1.0)


def _ftrl_state(p, slots, g, lr):
    """FTRL's accumulators after one gradient: (z, norm_new)."""
    norm_new = slots["norm"] + g * g
    sigma = (torch.sqrt(norm_new) - torch.sqrt(slots["norm"])) / lr
    return slots["zero"] + g - sigma * p, norm_new


@dataclasses.dataclass(frozen=True)
class Ftrl(RowOptimizer):
    """FTRL-proximal with lazy weight reconstruction (ref:
    ftrl_optimizer.cc:56-76), with the textbook shrinkage sign(z)*l1 - z
    as the JAX package has it."""
    learning_rate: float = 0.01
    beta: float = 0.0
    initial_accumulator_value: float = 0.1
    l1_regularization_strength: float = 0.0
    l2_regularization_strength: float = 0.0

    def slot_spec(self, dim):
        return {"zero": (dim, 0.0), "norm": (dim, self.initial_accumulator_value)}

    def apply(self, p, slots, g, lr, step):
        z, norm_new = _ftrl_state(p, slots, g, lr)
        l1 = self.l1_regularization_strength
        shrink = torch.sign(z) * l1 - z
        denom = (torch.sqrt(norm_new) + self.beta
                 + self.l2_regularization_strength * lr)
        p_new = torch.where(torch.abs(z) > l1, lr * shrink / denom, 0.0)
        return p_new, {"zero": z, "norm": norm_new}


@dataclasses.dataclass(frozen=True)
class GroupFtrl(RowOptimizer):
    """FTRL with group lasso over the whole segment of a row (ref:
    group_ftrl_optimizer.cc): the segment is zeroed when z's norm over its
    columns is at or below the l1 strength."""
    learning_rate: float = 0.01
    beta: float = 1.0
    initial_accumulator_value: float = 0.0
    l1_regularization_strength: float = 0.0
    l2_regularization_strength: float = 0.0

    def slot_spec(self, dim):
        return {"zero": (dim, 0.0), "norm": (dim, self.initial_accumulator_value)}

    def apply(self, p, slots, g, lr, step):
        z, norm_new = _ftrl_state(p, slots, g, lr)
        z_norm = torch.sqrt(torch.sum(z * z, dim=-1, keepdim=True))
        l1 = self.l1_regularization_strength
        denom = ((self.beta + torch.sqrt(norm_new)) / lr
                 + self.l2_regularization_strength)
        coeff = torch.where(
            z_norm > l1,
            -(1.0 - l1 / torch.clamp(z_norm, min=1e-30)) / denom, 0.0)
        return coeff * z, {"zero": z, "norm": norm_new}


@dataclasses.dataclass(frozen=True)
class GroupAdagrad(RowOptimizer):
    """Adagrad with a single shared accumulator per row + group-lasso
    shrinkage (ref: group_adagrad_optimizer.cc:50-88)."""
    learning_rate: float = 0.01
    beta: float = 0.0
    initial_accumulator_value: float = 0.1
    l2_regularization_strength: float = 0.0
    weight_decay_factor: float = 0.0

    def slot_spec(self, dim):
        return {"grad_square_sum": (1, self.initial_accumulator_value)}

    def apply(self, p, slots, g, lr, step):
        g = _decayed(g, p, self.weight_decay_factor)
        max_g2 = torch.amax(g * g, dim=-1, keepdim=True)
        gss = slots["grad_square_sum"] + max_g2
        lr_t = lr / (self.beta + torch.sqrt(gss))
        z = g - p / lr_t
        z_norm = torch.sqrt(torch.sum(z * z, dim=-1, keepdim=True))
        l2 = self.l2_regularization_strength
        coeff = torch.where(
            z_norm < l2, 0.0,
            -lr_t * (z_norm - l2) / torch.clamp(z_norm, min=1e-30))
        return coeff * z, {"grad_square_sum": gss}


@dataclasses.dataclass(frozen=True)
class BatchSoftmax(RowOptimizer):
    """Tracks the EMA of the inter-occurrence step gap of an item, used for
    sampled-softmax logQ correction (ref: batch_softmax_optimizer.cc:50-60):
    value <- (1-lr)*value + lr*(step - last_step); last_step <- step.
    dim must be 1."""
    learning_rate: float = 0.1

    def slot_spec(self, dim):
        if dim != 1:
            raise ValueError(f"BatchSoftmax requires dim=1 (got {dim})")
        return {"last_step": (1, 0.0)}

    def apply(self, p, slots, g, lr, step):
        gap = float(step) - slots["last_step"]
        p = (1 - lr) * p + lr * gap
        return p, {"last_step": torch.full_like(slots["last_step"],
                                                float(step))}


@dataclasses.dataclass(frozen=True)
class DC(RowOptimizer):
    """Delta-compensation gradient decorator (ref: dc_optimizer.cc:30-44):
    g' = g + lambda * g^2 * (stale_param - latest_param), then the base
    optimizer. Staleness arises in the 1-step-stale asynchronous block
    (EngineConfig.async_optimize: the forward reads rows before the previous
    step's write-back lands); there `optimize_packed` calls `stale_apply`
    with the rows the forward used. In synchronous steps staleness is zero
    and DC is its base optimizer."""
    learning_rate: float = 0.01
    lambda_: float = 0.0
    base: RowOptimizer = dataclasses.field(default_factory=lambda: SGD())

    def slot_spec(self, dim):
        return self.base.slot_spec(dim)

    def apply(self, p, slots, g, lr, step, stale_p=None):
        if stale_p is not None:
            g = g + self.lambda_ * g * g * (stale_p - p)
        return self.base.apply(p, slots, g, lr, step)

    def stale_apply(self, p, slots, g, lr, step, stale_p):
        """optimize_packed's hook for the asynchronous block."""
        return self.apply(p, slots, g, lr, step, stale_p=stale_p)


NAMED_OPTIMIZERS = {
    "sgd": SGD,
    "adagrad": Adagrad,
    "dynamic_wd_adagrad": DynamicWdAdagrad,
    "adadelta": Adadelta,
    "adam": Adam,
    "amsgrad": AMSGrad,
    "momentum": Momentum,
    "moving_average": MovingAverage,
    "rmsprop": RMSprop,
    "rmspropv2": RMSpropV2,
    "ftrl": Ftrl,
    "group_ftrl": GroupFtrl,
    "group_adagrad": GroupAdagrad,
    "batch_softmax": BatchSoftmax,
    "dc": DC,
}

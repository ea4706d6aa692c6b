"""Normalization layers and GradNorm multi-task loss balancing (ref
layers/norms.py: BatchNorm :27, LayerNorm :194, GradNorm :247), the port of
the JAX package's layers/norms.py.

BatchNorm and LayerNorm compute as flax's do, not as torch's:

- statistics in f32 over every axis but the last, the variance the biased
  E[x^2] - E[x]^2 clipped at 0 (flax's `use_fast_variance`);
- y = (x - mean) * (rsqrt(var + epsilon) * scale) + bias, in that order;
- BatchNorm's running averages move by ra = momentum * ra + (1 - momentum)
  * batch with flax's momentum 0.99 (torch's convention is the other
  way round, and its running variance unbiased), epsilon 1e-5; LayerNorm's
  epsilon is flax's 1e-6.

Parameters are `scale` and `bias`; BatchNorm's running statistics are the
buffers `mean` and `var`, which the trainer reads out as flax's
`batch_stats` collection by those names. A BatchNorm normalizes by its
running averages in `eval()` mode and whenever `use_running_average` is
set; otherwise by the batch's statistics, updating the averages.

GradNorm is the JAX layer's: the caller gives per-task losses and per-task
gradient norms with respect to a shared activation (`grad_norms_wrt`,
which keeps the graph of those gradients, so the balancing loss is
differentiated to second order as `jax.grad` of a `jax.grad` is).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn


def _stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's `_compute_stats` with `use_fast_variance`: mean and biased
    variance in f32 over every axis but the last."""
    x = x.float()
    axes = tuple(range(x.ndim - 1))
    mean = x.mean(dim=axes)
    mean2 = (x * x).mean(dim=axes)
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def _normalize(x, mean, var, epsilon, scale, bias):
    y = x - mean
    mul = torch.rsqrt(var + epsilon)
    if scale is not None:
        mul = mul * scale
    y = y * mul
    if bias is not None:
        y = y + bias
    return y


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over the last axis of [..., num_features]."""

    def __init__(self, num_features: int,
                 use_running_average: Optional[bool] = None,
                 momentum: float = 0.99, epsilon: float = 1e-5,
                 use_bias: bool = True, use_scale: bool = True):
        super().__init__()
        self.use_running_average = use_running_average
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = (nn.Parameter(torch.ones(num_features)) if use_scale
                      else None)
        self.bias = (nn.Parameter(torch.zeros(num_features)) if use_bias
                     else None)
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_running_average or not self.training:
            mean, var = self.mean, self.var
        else:
            mean, var = _stats(x)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return _normalize(x, mean, var, self.epsilon, self.scale, self.bias)


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm` over the last axis of [..., num_features]."""

    def __init__(self, num_features: int, epsilon: float = 1e-6,
                 use_bias: bool = True, use_scale: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.scale = (nn.Parameter(torch.ones(num_features)) if use_scale
                      else None)
        self.bias = (nn.Parameter(torch.zeros(num_features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        return _normalize(x, mean, var, self.epsilon, self.scale, self.bias)


class GradNorm(nn.Module):
    """ref :247: task weights w = softmax(`grad_norm_weights`, zeros at
    init); wgnorms = w * gnorms; gnorm_loss = scale * sum(|d|^loss_pow)
    with d = (wgnorms - avg) / (avg + epsilon) if relative_diff, else
    wgnorms - avg; weighted_loss = sum(w * losses). forward(losses [T],
    gnorms [T]) -> (weighted_loss, gnorm_loss)."""

    def __init__(self, num_tasks: int, scale: float = 1.0,
                 loss_pow: float = 2.0, relative_diff: bool = False,
                 epsilon: float = 1e-6):
        super().__init__()
        self.scale, self.loss_pow = scale, loss_pow
        self.relative_diff, self.epsilon = relative_diff, epsilon
        self.grad_norm_weights = nn.Parameter(torch.zeros(num_tasks))

    def forward(self, losses: torch.Tensor, gnorms: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = torch.softmax(self.grad_norm_weights, dim=0)
        wgnorms = w * gnorms
        avg = wgnorms.mean()
        diff = wgnorms - avg
        if self.relative_diff:
            diff = diff / (avg + self.epsilon)
        gnorm_loss = self.scale * torch.sum(torch.abs(diff) ** self.loss_pow)
        return torch.sum(w * losses), gnorm_loss


def grad_norms_wrt(shared: torch.Tensor, task_losses_fn: Callable, *args
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-task gradient norms with respect to a shared activation.
    task_losses_fn(shared, *args) -> [T] losses. Returns (losses [T],
    gnorms [T]); each norm keeps its graph (create_graph), so a loss on
    the norms differentiates to second order."""
    if not shared.requires_grad:
        shared = shared.detach().requires_grad_()
    losses = task_losses_fn(shared, *args)
    gnorms = []
    for i in range(losses.shape[0]):
        (g,) = torch.autograd.grad(losses[i], shared, create_graph=True,
                                   retain_graph=True)
        gnorms.append(torch.sqrt(torch.sum(g * g)))
    return losses, torch.stack(gnorms)

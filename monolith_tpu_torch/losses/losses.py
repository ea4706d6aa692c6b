"""Ranking / CTR losses."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable sigmoid cross-entropy, mean-reduced (the JAX
    package's formula, term for term, with its gradients at a logit of
    exactly 0: jnp.maximum splits a tie, d max(x, 0)/dx = 1/2, and
    d|x|/dx = 1 there, so the gradient is -label; torch.clamp's 1 and
    torch.abs's 0 would give 1 - label, which is 0 for a positive. A model
    whose logits start at exactly 0 (zero embeddings into zero biases)
    meets that point at its first step. (x + |x|) / 2 is max(x, 0)
    exactly in floating point."""
    abs_ = torch.where(logits >= 0, logits, -logits)   # d/dx = 1 at 0
    loss = (0.5 * (logits + torch.abs(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_)))
    return loss.mean()

"""Ranking / CTR losses."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable sigmoid cross-entropy, mean-reduced (the JAX
    package's formula, term for term)."""
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss.mean()

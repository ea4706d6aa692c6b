"""Ranking / CTR losses (ref losses/: inbatch_auc_loss.py with its C++ op
runtime/ops/inbatch_auc_loss.cc, the batch softmax loss), the port of the
JAX package's losses/losses.py. The pairwise AUC surrogate is a dense
[B, B] comparison, as in the JAX package."""

from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    sample_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Numerically-stable sigmoid cross-entropy, mean-reduced (or weighted
    by `sample_weight`, over max(sum of weights, 1e-12)): the JAX
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
    if sample_weight is not None:
        loss = loss * sample_weight
        return loss.sum() / torch.clamp(sample_weight.sum(), min=1e-12)
    return loss.mean()


def inbatch_auc_loss(logits: torch.Tensor, labels: torch.Tensor,
                     negative_weight: float = 1.0) -> torch.Tensor:
    """Pairwise AUC surrogate over in-batch (positive i, negative j) pairs:
    negative_weight * the mean over those pairs of -log sigmoid(logit_i -
    logit_j), as log1p(exp(-diff))."""
    labels = labels.float()
    pair_w = labels[:, None] * (1.0 - labels)[None, :]   # [B, B]
    diff = logits[:, None] - logits[None, :]
    pair_loss = torch.log1p(torch.exp(-diff))
    total_w = torch.clamp(pair_w.sum(), min=1.0)
    return negative_weight * torch.sum(pair_loss * pair_w) / total_w


def batch_softmax_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       item_log_q: Optional[torch.Tensor] = None,
                       temperature: float = 1.0) -> torch.Tensor:
    """Sampled in-batch softmax for retrieval towers, each user's own item
    the positive, with the optional logQ correction (item_log_q [B])."""
    logits = user_emb @ item_emb.T / temperature  # [B, B]
    if item_log_q is not None:
        logits = logits - item_log_q[None, :]
    logits = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    return -torch.mean(torch.diagonal(logits))

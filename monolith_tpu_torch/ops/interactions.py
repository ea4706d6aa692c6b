"""Feature-interaction compute ops (plain tensor code; no kernel needed)."""

from __future__ import annotations

import torch


def fm_interaction(embs: torch.Tensor) -> torch.Tensor:
    """Second-order factorization-machine interaction (sum-square trick).

    embs: [B, F, D] per-field embeddings -> [B, D]:
      0.5 * ((sum_f e_f)^2 - sum_f e_f^2)
    """
    sum_sq = torch.square(embs.sum(dim=1))
    sq_sum = torch.square(embs).sum(dim=1)
    return 0.5 * (sum_sq - sq_sum)

"""Feature-interaction compute ops (plain tensor code, as in the JAX
package, where XLA maps them onto the matrix units; no kernel needed): the
FM interaction, the field-aware FFM crossing (ref layers/layer_ops.py
ffm(), kernels ffm_kernels.cc) and DLRM's pairwise dot interaction."""

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


def ffm_interaction(left: torch.Tensor, right: torch.Tensor,
                    dim_size: int, int_type: str = "multiply") -> torch.Tensor:
    """Cross every left field with every right field.

    left:  [B, F1 * dim_size]
    right: [B, F2 * dim_size]
    int_type "multiply": elementwise products -> [B, F1*F2*dim_size]
    int_type "dot":      dot products         -> [B, F1*F2]
    """
    b = left.shape[0]
    f1 = left.shape[1] // dim_size
    f2 = right.shape[1] // dim_size
    prod = (left.reshape(b, f1, 1, dim_size)
            * right.reshape(b, 1, f2, dim_size))   # [B, F1, F2, D]
    if int_type == "multiply":
        return prod.reshape(b, f1 * f2 * dim_size)
    if int_type == "dot":
        return prod.sum(dim=-1).reshape(b, f1 * f2)
    raise ValueError(f"unknown int_type: {int_type}")


def dot_interaction(embs: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    """DLRM-style pairwise dot interaction: [B, F, D] -> [B, F*(F-1)/2]
    (the upper triangle of the F x F gram matrix; with the diagonal when
    `self_interaction`). The JAX function's `keep_diag` is never read, so
    the port has none."""
    gram = torch.einsum("bfd,bgd->bfg", embs, embs)
    f = embs.shape[1]
    rows, cols = torch.triu_indices(f, f, offset=0 if self_interaction else 1,
                                    device=embs.device)
    return gram[:, rows, cols]

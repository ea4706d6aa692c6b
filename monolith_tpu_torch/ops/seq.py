"""Sequence mask op (ref gen_seq_mask.py + runtime/ops/gen_seq_mask.cc),
the port of the JAX package's ops/seq.py."""

from __future__ import annotations

import torch


def gen_seq_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """lengths [B] -> bool mask [B, max_length]."""
    pos = torch.arange(max_length, dtype=lengths.dtype,
                       device=lengths.device)[None, :]
    return pos < lengths[:, None]

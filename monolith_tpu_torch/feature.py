"""Feature API: feature -> table mapping and embedding combiners.

A `FeatureConfig` names one sparse feature, the merged `TableSpec` it reads,
and how its ids per example are pooled ("sum" / "mean": [B, dim];
"firstn": the unpooled [B, max_length, dim] sequence).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    name: str
    table: str                 # TableSpec.name
    max_length: int            # ids per example (static pad length)
    combiner: str = "sum"      # sum | mean | firstn
    slice_dims: Optional[Tuple[int, ...]] = None  # optional per-slice split view

    def output_dim(self, table_dim: int) -> int:
        return table_dim


def combine(emb: torch.Tensor, valid: torch.Tensor, combiner: str) -> torch.Tensor:
    """Pool per-example id embeddings.

    emb: [B, L, D] (invalid slots already zero), valid: [B, L] bool. The
    mean's denominator is max(count, 1)."""
    if combiner == "sum":
        return emb.sum(dim=1)
    if combiner == "mean":
        denom = torch.clamp(valid.to(emb.dtype).sum(dim=1, keepdim=True),
                            min=1.0)
        return emb.sum(dim=1) / denom
    if combiner == "firstn":
        return emb
    raise ValueError(f"unknown combiner: {combiner}")

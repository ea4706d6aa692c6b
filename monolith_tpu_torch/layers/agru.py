"""GRU and attention-gated GRU cells and their recurrences (ref
layers/agru.py AGRUCell :51, dynamic_rnn_with_attention), the port of the
JAX package's layers/agru.py.

The cells are the JAX package's, gate for gate: `z`, `r` and `h` are
separate Dense layers (lecun-normal kernels, zero biases) over
[x, h] and [x, r * h]; this is neither `nn.GRUCell`'s gate layout nor its
biases. The recurrences step over the time axis in order, from a zero
state, as flax's `nn.scan` does; their cells sit at `gru.cell` and
`augru.cell`, the scan's parameter paths, so converted weights land by
name. `GRU` masks its outputs after the loop (padded steps still move the
state, as in JAX); `AUGRU` returns the final state.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from monolith_tpu_torch.layers.initializers import dense


class GRUCell(nn.Module):
    def __init__(self, input_dim: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z = dense(input_dim + units, units, generator)
        self.r = dense(input_dim + units, units, generator)
        self.h = dense(input_dim + units, units, generator)

    def _step(self, h, x, att_score=None):
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(self.z(xh))
        if att_score is not None:
            z = z * att_score[..., None]
        r = torch.sigmoid(self.r(xh))
        hh = torch.tanh(self.h(torch.cat([x, r * h], dim=-1)))
        return (1 - z) * h + z * hh

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._step(h, x)


class AGRUCell(GRUCell):
    """Attention-gated GRU (AUGRU, ref agru.py:51): the update gate is
    scaled by the step's attention score."""

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                att_score: torch.Tensor) -> torch.Tensor:
        return self._step(h, x, att_score)


class _Scan(nn.Module):
    """Holds the scanned cell under flax's path `<scan>.cell`."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell


class GRU(nn.Module):
    """GRUCell over [B, T, D] -> (outputs [B, T, units], final [B, units])."""

    def __init__(self, input_dim: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.units = units
        self.gru = _Scan(GRUCell(input_dim, units, generator))

    def forward(self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None):
        h = xs.new_zeros((xs.shape[0], self.units))
        outs = []
        for t in range(xs.shape[1]):
            h = self.gru.cell(h, xs[:, t])
            outs.append(h)
        outs = torch.stack(outs, dim=1)
        if mask is not None:
            outs = outs * mask[..., None]
        return outs, h


class AUGRU(nn.Module):
    """AGRUCell over [B, T, D] with attention scores [B, T] -> final
    [B, units]."""

    def __init__(self, input_dim: int, units: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.units = units
        self.augru = _Scan(AGRUCell(input_dim, units, generator))

    def forward(self, xs: torch.Tensor, att_scores: torch.Tensor
                ) -> torch.Tensor:
        h = xs.new_zeros((xs.shape[0], self.units))
        for t in range(xs.shape[1]):
            h = self.augru.cell(h, xs[:, t], att_scores[:, t])
        return h

"""Logit correction for negative-sampled training (ref
layers/logit_correction.py:29), the port of the JAX package's
layers/logit_correction.py: corrected = log_sigmoid(logit) if
`sample_bias`, minus log(max(sample_rate, 1e-20)) if a rate is given, as
LogitCorrection.get_sample_logits computes it."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def logit_correction(logits: torch.Tensor,
                     sample_rate: Optional[torch.Tensor] = None,
                     sample_bias: bool = False) -> torch.Tensor:
    out = F.logsigmoid(logits) if sample_bias else logits
    if sample_rate is not None:
        out = out - torch.log(torch.clamp(sample_rate, min=1e-20))
    return out


class LogitCorrection(nn.Module):
    def __init__(self, sample_bias: bool = False):
        super().__init__()
        self.sample_bias = sample_bias

    def forward(self, logits, sample_rate=None):
        return logit_correction(logits, sample_rate, self.sample_bias)

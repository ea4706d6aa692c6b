"""Feature-insight and fid-counter ops (ref layers/kernels/
feature_insight_kernels.cc, fid_counter_kernel.cc, python wrappers
layers/layer_ops.py:49-130), the port of the JAX package's ops/insight.py.

- feature_insight: per-feature-segment projection. For each feature f
  owning a contiguous slice of the embedding's columns, out[b, f*K + k] =
  sum over j in seg_f of in[b, j] * w[j, k]: one matmul a segment,
  concatenated; autograd gives the reference's FeatureInsightGrad (the
  plain matmul gradient of each segment).
- fid_counter: an occurrence counter kept in an embedding slot. Forward is
  min(counter + step, threshold); the backward DISCARDS the upstream
  gradient and gives -step (0 once the counter has reached the threshold),
  so that SGD(1.0) on the slot applies counter -= lr * (-step), one bump
  an occurrence. That needs a `torch.autograd.Function` (autograd would
  give 0 on the clipped branch), as it needs `jax.custom_vjp` in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch


def feature_insight(input_embedding: torch.Tensor, weight: torch.Tensor,
                    segment_sizes: Sequence[int],
                    aggregate: bool = False) -> torch.Tensor:
    """Per-feature projection of a concatenated embedding.

    input_embedding [B, sum(segment_sizes)], weight [sum(segment_sizes),
    K]. Returns [B, F*K] (feature-major), or with `aggregate` the
    reference's insight score sum_k out[b, f, k]^2 as [B, F]
    (layer_ops.py:57-70)."""
    assert len(segment_sizes) > 0
    assert input_embedding.shape[-1] == weight.shape[0], (
        input_embedding.shape, weight.shape)
    outs, start = [], 0
    for size in segment_sizes:
        outs.append(input_embedding[:, start:start + size]
                    @ weight[start:start + size, :])
        start += size
    out = torch.cat(outs, dim=1)  # [B, F*K]
    if aggregate:
        sq = out * out
        return sq.reshape(out.shape[0], len(segment_sizes),
                          weight.shape[1]).sum(dim=2)
    return out


class _FidCounterGrad(torch.autograd.Function):
    """Identity forward; backward -step where counter < threshold, else 0,
    whatever the upstream gradient (ref layer_ops.py:124-131)."""

    @staticmethod
    def forward(ctx, counter, step: float, threshold: float):
        ctx.save_for_backward(counter)
        ctx.step, ctx.threshold = step, threshold
        return counter.view_as(counter)

    @staticmethod
    def backward(ctx, grad):
        (counter,) = ctx.saved_tensors
        g = torch.where(counter >= ctx.threshold, torch.zeros_like(counter),
                        torch.full_like(counter, -ctx.step))
        return g, None, None


def fid_counter(counter: torch.Tensor, counter_threshold: int,
                step: float = 1.0) -> torch.Tensor:
    """Occurrence counter through an embedding slot (ref layer_ops.py:90).
    The slot's optimizer must be SGD(1.0): each train step the gradient
    -step bumps the stored counter by +step until it reaches
    counter_threshold. Returns min(counter + step, threshold)."""
    c = _FidCounterGrad.apply(counter, float(step), float(counter_threshold))
    c = c + torch.tensor(step, dtype=c.dtype, device=c.device)
    return torch.minimum(c, torch.tensor(counter_threshold, dtype=c.dtype,
                                         device=c.device))

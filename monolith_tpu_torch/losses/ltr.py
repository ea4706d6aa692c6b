"""Learning-to-rank losses (ref losses/ltr_losses.py: RankingLossKey :253,
make_loss_fn :266, the pairwise template :781, softmax :967, sigmoid CE
:1025, MSE :1067, ListMLE :1107, ApproxNDCG :1177), the port of the JAX
package's losses/ltr.py. Inputs follow the reference's convention:

  labels  [B, L]  graded relevance; entries < 0 are INVALID (padding)
  logits  [B, L]  ranking scores
  weights None | scalar | [B, 1] listwise | [B, L] itemwise

Invalid entries take zero weight instead of being masked out, and the
"SUM_BY_NONZERO_WEIGHTS" reduction divides by the count of nonzero
weights, as the JAX package computes them with static shapes. |x| is
`where(x >= 0, x, -x)` wherever the JAX formula has jnp.abs of a logit,
for JAX's gradient of 1 at 0 (torch.abs has 0 there).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

_EPSILON = 1e-10


def _log_epsilon(like: torch.Tensor) -> torch.Tensor:
    """log(1e-10) computed in f32, as jnp.log(_EPSILON) is."""
    return torch.log(torch.tensor(_EPSILON, dtype=torch.float32,
                                  device=like.device))


def _abs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, -x)


def _valid(labels: torch.Tensor) -> torch.Tensor:
    return labels >= 0.0  # ref label_valid_fn (ltr_losses.py:51)


def _as_f32(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    device = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _item_weights(labels: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return torch.ones_like(labels)
    return _as_f32(weights, labels).expand(labels.shape)


def _reduce_by_nonzero(losses: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """tf.losses Reduction.SUM_BY_NONZERO_WEIGHTS with static shapes."""
    num = torch.sum(losses * weights)
    den = torch.clamp(torch.sum((weights != 0).float()), min=1.0)
    return num / den


def _pairwise(loss_of_logits: Callable, labels, logits, weights=None):
    """Pairs (i, j) with l_i > l_j, both valid, weigh w_i * |l_i - l_j|
    (ref _pairwise_comparison :715, _pairwise_loss :781)."""
    labels, logits = _as_f32(labels), _as_f32(logits)
    w = _item_weights(labels, weights)
    ld = labels[:, :, None] - labels[:, None, :]          # [B, L, L]
    sd = logits[:, :, None] - logits[:, None, :]
    valid = _valid(labels)
    pair_valid = (valid[:, :, None] & valid[:, None, :]).float()
    pw = (ld > 0).float() * pair_valid
    pw = (pw * w[:, :, None] * torch.abs(ld)).detach()
    return _reduce_by_nonzero(loss_of_logits(sd), pw)


def pairwise_hinge_loss(labels, logits, weights=None):
    """max(0, 1 - (s_i - s_j)) for l_i > l_j (ref :823)."""
    return _pairwise(lambda s: torch.relu(1.0 - s), labels, logits, weights)


def pairwise_logistic_loss(labels, logits, weights=None):
    """log(1 + exp(-(s_i - s_j))) for l_i > l_j (ref :870)."""
    return _pairwise(
        lambda s: torch.relu(-s) + torch.log1p(torch.exp(-_abs(s))),
        labels, logits, weights)


def pairwise_soft_zero_one_loss(labels, logits, weights=None):
    """1 - P(l_i > l_j), P = sigmoid(s_i - s_j) (ref :918)."""
    return _pairwise(
        lambda s: torch.where(s > 0, 1.0 - torch.sigmoid(s),
                              torch.sigmoid(-s)),
        labels, logits, weights)


def softmax_loss(labels, logits, weights=None):
    """Listwise softmax cross entropy over valid items (ref :967): each
    list weighs its (weighted) label sum; zero-label lists drop out."""
    labels, logits = _as_f32(labels), _as_f32(logits)
    valid = _valid(labels)
    w = _item_weights(labels, weights)
    labels = torch.where(valid, labels, 0.0) * w
    logits = torch.where(valid, logits, _log_epsilon(logits))
    label_sum = labels.sum(dim=1, keepdim=True)              # [B, 1]
    target = labels / torch.clamp(label_sum, min=_EPSILON)
    ce = -torch.sum(target * torch.log_softmax(logits, dim=-1), dim=-1)
    return _reduce_by_nonzero(ce, label_sum[:, 0])


def sigmoid_cross_entropy_loss(labels, logits, weights=None):
    """Per-item sigmoid cross entropy over valid items (ref :1025)."""
    labels, logits = _as_f32(labels), _as_f32(logits)
    valid = _valid(labels)
    w = _item_weights(labels, weights) * valid
    safe_labels = torch.where(valid, labels, 0.0)
    ce = (torch.relu(logits) - logits * safe_labels
          + torch.log1p(torch.exp(-_abs(logits))))
    return _reduce_by_nonzero(ce, w)


def mean_squared_loss(labels, logits, weights=None):
    """Per-item squared error over valid items (ref :1067)."""
    labels, logits = _as_f32(labels), _as_f32(logits)
    valid = _valid(labels)
    w = _item_weights(labels, weights) * valid
    safe_labels = torch.where(valid, labels, 0.0)
    return _reduce_by_nonzero((safe_labels - logits) ** 2, w)


def _list_weights(weights, like: torch.Tensor, batch: int, item: bool
                  ) -> torch.Tensor:
    """One weight a list: ones; a scalar everywhere; or the first column
    of listwise [B, 1] (ListMLE) / of any [B, 1] or [B, L] (ApproxNDCG,
    item=True) weights, as the JAX losses broadcast them."""
    if weights is None:
        return torch.ones_like(like)
    w = _as_f32(weights, like)
    if w.ndim == 0:
        return torch.full_like(like, float(w))
    return w.expand(batch, -1 if item else 1)[:, 0]


def list_mle_loss(labels, logits, weights=None,
                  generator: Optional[torch.Generator] = None):
    """ListMLE [Xia et al. 2008] (ref :1107): the negative log-likelihood
    of the label-sorted permutation under the Plackett-Luce model.
    `generator` adds the reference's random tie-break (uniform noise in
    [0, 1e-3) on the labels, ref shuffle_valid_indices :133; JAX takes a
    key); None keeps it deterministic, ties in index order."""
    labels, logits = _as_f32(labels), _as_f32(logits)
    valid = _valid(labels)
    labels = torch.where(valid, labels, 0.0)
    logits = torch.where(valid, logits, _log_epsilon(logits))
    sort_keys = labels
    if generator is not None:
        sort_keys = labels + torch.rand(labels.shape, generator=generator,
                                        device=labels.device) * 1e-3
    order = torch.argsort(-sort_keys, dim=1, stable=True)
    sorted_logits = torch.gather(logits, 1, order)
    sorted_logits = sorted_logits - sorted_logits.max(dim=1,
                                                      keepdim=True).values
    # reverse cumulative logsumexp
    sums = torch.log(torch.cumsum(torch.exp(sorted_logits.flip(1)), dim=1))
    nll = (sums.flip(1) - sorted_logits).sum(dim=1)          # [B]
    return _reduce_by_nonzero(
        nll, _list_weights(weights, nll, labels.shape[0], item=False))


def approx_ranks(logits: torch.Tensor, alpha: float = 10.0) -> torch.Tensor:
    """rank_i ~= 0.5 + sum_j sigmoid(alpha * (s_j - s_i)) (ref :160)."""
    pairs = torch.sigmoid(alpha * (logits[:, None, :] - logits[:, :, None]))
    return pairs.sum(dim=-1) + 0.5


def inverse_max_dcg(labels: torch.Tensor) -> torch.Tensor:
    """1 / DCG of the ideal ordering [B, 1], 0 for all-zero lists
    (ref :193)."""
    ideal = -torch.sort(-labels, dim=1).values
    rank = torch.arange(1, labels.shape[1] + 1, dtype=torch.float32,
                        device=labels.device)
    dg = ((2.0 ** ideal - 1.0) / torch.log1p(rank)).sum(dim=1, keepdim=True)
    return torch.where(dg > 0, 1.0 / torch.clamp(dg, min=_EPSILON),
                       torch.zeros_like(dg))


def approx_ndcg_loss(labels, logits, weights=None, alpha: float = 10.0):
    """ApproxNDCG [Qin et al.] (ref :1177): -NDCG with sigmoid-approximated
    ranks, SUM-reduced as the reference's default; zero-label lists weigh
    0."""
    labels, logits = _as_f32(labels), _as_f32(logits)
    valid = _valid(labels)
    labels = torch.where(valid, labels, 0.0)
    logits = torch.where(
        valid, logits,
        -1e3 + logits.min(dim=-1, keepdim=True).values
        * torch.ones_like(logits))
    label_sum = labels.sum(dim=1)
    list_w = _list_weights(weights, label_sum, labels.shape[0], item=True)
    list_w = torch.where(label_sum > 0, list_w, 0.0)
    gains = 2.0 ** labels - 1.0
    discounts = 1.0 / torch.log1p(approx_ranks(logits, alpha=alpha))
    dcg = (gains * discounts).sum(dim=-1)
    cost = -dcg * inverse_max_dcg(labels)[:, 0]
    return torch.sum(cost * list_w)


class RankingLossKey:
    """Ranking loss key strings (ref ltr_losses.py:253)."""
    PAIRWISE_HINGE_LOSS = "pairwise_hinge_loss"
    PAIRWISE_LOGISTIC_LOSS = "pairwise_logistic_loss"
    PAIRWISE_SOFT_ZERO_ONE_LOSS = "pairwise_soft_zero_one_loss"
    SOFTMAX_LOSS = "softmax_loss"
    SIGMOID_CROSS_ENTROPY_LOSS = "sigmoid_cross_entropy_loss"
    MEAN_SQUARED_LOSS = "mean_squared_loss"
    LIST_MLE_LOSS = "list_mle_loss"
    APPROX_NDCG_LOSS = "approx_ndcg_loss"


_LOSS_FNS = {
    RankingLossKey.PAIRWISE_HINGE_LOSS: pairwise_hinge_loss,
    RankingLossKey.PAIRWISE_LOGISTIC_LOSS: pairwise_logistic_loss,
    RankingLossKey.PAIRWISE_SOFT_ZERO_ONE_LOSS: pairwise_soft_zero_one_loss,
    RankingLossKey.SOFTMAX_LOSS: softmax_loss,
    RankingLossKey.SIGMOID_CROSS_ENTROPY_LOSS: sigmoid_cross_entropy_loss,
    RankingLossKey.MEAN_SQUARED_LOSS: mean_squared_loss,
    RankingLossKey.LIST_MLE_LOSS: list_mle_loss,
    RankingLossKey.APPROX_NDCG_LOSS: approx_ndcg_loss,
}


def make_loss_fn(loss_keys,
                 loss_weights: Optional[Sequence[float]] = None,
                 extra_args: Optional[Dict[str, Dict]] = None) -> Callable:
    """Weighted sum of named ranking losses (ref :266). `extra_args` maps
    a loss key to that loss's keyword arguments (e.g.
    {"approx_ndcg_loss": {"alpha": 5.0}}). Returns fn(labels, logits,
    weights=None) -> scalar loss."""
    if isinstance(loss_keys, str):
        loss_keys = [loss_keys]
    for k in loss_keys:
        if k not in _LOSS_FNS:
            raise ValueError(f"unknown ranking loss '{k}'")
    if loss_weights is not None and len(loss_weights) != len(loss_keys):
        raise ValueError("loss_weights must match loss_keys")
    lw = list(loss_weights) if loss_weights else [1.0] * len(loss_keys)
    kw = extra_args or {}

    def _loss_fn(labels, logits, weights=None):
        total = 0.0
        for k, w in zip(loss_keys, lw):
            total = total + w * _LOSS_FNS[k](labels, logits, weights,
                                             **kw.get(k, {}))
        return total

    return _loss_fn

"""DeepFM (Guo et al., IJCAI 2017, arXiv:1703.04247) in plain PyTorch:
logit = sum of the fields' first-order weights + the FM second-order term
0.5 * ((sum_f e_f)^2 - sum_f e_f^2) summed over the dim + a deep tower
over the concatenated field vectors. Each id's row is [bias (1) | vector
(dim)]. Fields: the configuration's, one id each, all in one table."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import common


def tables(cfg: Dict) -> Dict[str, list]:
    """{table: [feature, ...]} in the order a batch's ids are listed."""
    return {"sparse": list(cfg["fields"])}


def features(cfg: Dict) -> Dict[str, tuple]:
    """{feature: (max_length, combiner)}."""
    return {n: (1, "sum") for n in cfg["fields"]}


def _tower(cfg: Dict) -> list:
    return [len(cfg["fields"]) * cfg["embedding_dim"], *cfg["hidden"], 1]


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    return common.mlp_shapes("deep", _tower(cfg))


def forward(params: Dict[str, torch.Tensor], pooled: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    d = cfg["embedding_dim"]
    names = list(cfg["fields"])
    linear = sum(pooled[n][:, 0] for n in names)
    vecs = torch.stack([pooled[n][:, 1:1 + d] for n in names], dim=1)
    fm = 0.5 * (vecs.sum(dim=1) ** 2 - (vecs ** 2).sum(dim=1)).sum(dim=-1)
    deep = common.mlp(vecs.reshape(vecs.shape[0], -1), params, "deep",
                      len(_tower(cfg)) - 1)[:, 0]
    return linear + fm + deep


def train_flops_per_example(cfg: Dict) -> int:
    """FLOPs of one example's forward and backward, no recomputation: the
    tower's products (forward, then the input and the weight gradient,
    twice the forward) and the FM term (two sums of F field vectors and
    their squares, as multiply-adds, forward and twice backward)."""
    fields, d = len(cfg["fields"]), cfg["embedding_dim"]
    return 3 * (common.mlp_flops(_tower(cfg)) + 2 * 2 * fields * d)

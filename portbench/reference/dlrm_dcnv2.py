"""DLRM with a DCN V2 interaction, as MLPerf Training's DLRM-DCNv2 runs it on
Criteo 1TB with multi-hot features, in plain PyTorch (float32, TF32 off).

Sources: the MLCommons reference (mlcommons/training,
recommendation_v2/torchrec_dlrm) and Wang et al., "DCN V2: Improved Deep &
Cross Network", arXiv:2008.13535. It imports nothing of the program under
test: no kernels, no id cache, no batching.

The model, from the configuration (`cfg`, the benchmark's JSON):

- 13 dense inputs (`batch["dense"]` [B, 13], already log(1 + x)) through
  a bottom MLP (`bottom_mlp`, 512-256-128), ReLU after every layer;
- 26 features C1..C26, each a sum-pooled bag of `multi_hot_sizes[i]` ids
  on a table of its own, `embedding_dim` (128) wide;
- the concatenation [bottom | C1 | ... | C26] (3456 wide) through
  `cross_layers` low-rank cross layers of rank `cross_rank`:
  x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, V_l [rank, D], W_l [D, rank];
- a top MLP (`top_mlp`, 1024-1024-512-256-1), ReLU after every layer but
  the last; the loss is the mean sigmoid cross-entropy.

A training step (`run`), as the configuration states it:

- per table, the batch's ids in first-occurrence order (row-major; -1 is
  padding); an id seen for the first time is admitted: its accumulator
  starts at `accumulator_init` and its vector at uniform(-b, b), b =
  sqrt(1 / the table's published rows), the id at position j of the
  step's id list taking row j of a [unique cap, dim] draw from a Philox
  generator seeded with (seed, step, table index in sorted name order);
- forward, loss, and the gradients of the dense parameters and of each
  id's row (summed over its occurrences);
- Adagrad on the tower (acc += g^2 from `dense_accumulator_init`; p -= lr
  * g / sqrt(acc + `dense_eps`)) and on the touched rows, per element (n
  += g^2; v -= lr * g / sqrt(n)).

Departures from MLPerf's reference, each as the configuration states it:

- the rows' Adagrad is per element (a 128-wide accumulator a row), where
  MLPerf's fused optimizer keeps one accumulator a row (row-wise Adagrad);
- no learning-rate schedule (MLPerf warms up and decays);
- the tower's Adagrad starts its accumulator at 0.1 with eps 1e-7 (the
  optax form of the program under test), where torch's starts at 0;
- the embeddings' init bound is torchrec's sqrt(1 / rows); the dense
  layers take the benchmark's glorot-uniform weights.

The row state of a table is a dict from id to slot (`_Rows`, a sorted id
array), with a [slots, dim] vector and accumulator tensor beside it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ----------------------------------------------------------------------
# the configuration
# ----------------------------------------------------------------------

def feature_names(cfg: Dict) -> List[str]:
    return [f"C{i + 1}" for i in range(len(cfg["multi_hot_sizes"]))]


def held_rows(cfg: Dict) -> Dict[str, int]:
    """Rows this card holds a table: `rows_<name>` where the configuration
    cuts the table, its published count otherwise."""
    return {n: int(cfg.get(f"rows_{n}", published))
            for n, published in zip(feature_names(cfg),
                                    cfg["num_embeddings_per_feature"])}


def init_bound(cfg: Dict, name: str) -> float:
    """torchrec's init bound of a table: sqrt(1 / its published rows)."""
    i = feature_names(cfg).index(name)
    return math.sqrt(1.0 / cfg["num_embeddings_per_feature"][i])


def tables(cfg: Dict) -> Dict[str, list]:
    """{table: [feature]}: one table a feature, named as it."""
    return {n: [n] for n in feature_names(cfg)}


def features(cfg: Dict) -> Dict[str, tuple]:
    """{feature: (ids a bag, combiner)}."""
    return {n: (h, "sum") for n, h in zip(feature_names(cfg),
                                          cfg["multi_hot_sizes"])}


def interaction_width(cfg: Dict) -> int:
    return cfg["bottom_mlp"][-1] + len(feature_names(cfg)) * cfg[
        "embedding_dim"]


def _mlp_shapes(prefix: str, widths) -> Dict[str, tuple]:
    out = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"{prefix}.dense_{i}.weight"] = (b, a)
        out[f"{prefix}.dense_{i}.bias"] = (b,)
    return out


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """The dense parameters by name: `bottom.dense_<i>.weight` [out, in] and
    `.bias`, `cross.v_<l>` [rank, D], `cross.w_<l>` [D, rank], `cross.b_<l>`
    [D], `top.dense_<i>.*`."""
    D, r = interaction_width(cfg), cfg["cross_rank"]
    out = _mlp_shapes("bottom", [cfg["num_dense"], *cfg["bottom_mlp"]])
    for i in range(cfg["cross_layers"]):
        out[f"cross.v_{i}"] = (r, D)
        out[f"cross.w_{i}"] = (D, r)
        out[f"cross.b_{i}"] = (D,)
    out.update(_mlp_shapes("top", [D, *cfg["top_mlp"]]))
    return out


# ----------------------------------------------------------------------
# the forward and its count
# ----------------------------------------------------------------------

def _mlp(x, params, prefix: str, layers: int, relu_last: bool):
    for i in range(layers):
        x = x @ params[f"{prefix}.dense_{i}.weight"].t() \
            + params[f"{prefix}.dense_{i}.bias"]
        if i < layers - 1 or relu_last:
            x = torch.relu(x)
    return x


def forward(params: Dict[str, torch.Tensor], pooled: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    """Logits [B] from the pooled bags {feature: [B, dim]} and the batch."""
    x = _mlp(batch["dense"], params, "bottom", len(cfg["bottom_mlp"]), True)
    x0 = torch.cat([x] + [pooled[n] for n in feature_names(cfg)], dim=1)
    x = x0
    for i in range(cfg["cross_layers"]):
        low = x @ params[f"cross.v_{i}"].t()
        x = x0 * (low @ params[f"cross.w_{i}"].t()
                  + params[f"cross.b_{i}"]) + x
    return _mlp(x, params, "top", len(cfg["top_mlp"]), False)[:, 0]


def _mlp_flops(widths) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def cross_flops_per_example(cfg: Dict) -> int:
    """FLOPs of the cross layers' products in one example's forward: two
    [D] x [D, rank] multiply-adds a layer."""
    return cfg["cross_layers"] * 2 * (2 * interaction_width(cfg)
                                      * cfg["cross_rank"])


def forward_flops_per_example(cfg: Dict) -> int:
    """FLOPs of one example's forward products: bottom MLP, cross, top MLP
    (the pooling's adds and the elementwise work left out)."""
    return (_mlp_flops([cfg["num_dense"], *cfg["bottom_mlp"]])
            + cross_flops_per_example(cfg)
            + _mlp_flops([interaction_width(cfg), *cfg["top_mlp"]]))


def train_flops_per_example(cfg: Dict) -> int:
    """FLOPs of one example's forward and backward, no recomputation: the
    forward's products, then the input and the weight gradient (twice the
    forward)."""
    return 3 * forward_flops_per_example(cfg)


# ----------------------------------------------------------------------
# the training steps
# ----------------------------------------------------------------------

def init_seed(seed: int, step: int, table_index: int) -> int:
    """Philox seed of a table's new-row init at a step (table index in
    sorted table-name order)."""
    return ((seed * 1_000_003 + step) * 1_009 + table_index) % (1 << 63)


def dedup(flat: np.ndarray):
    """(unique ids in first-occurrence order, position of each entry in
    that list or -1 for padding)."""
    valid = flat != -1
    uniq, first, inv = np.unique(flat[valid], return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    pos = np.full(flat.shape, -1, np.int64)
    pos[valid] = rank[inv.reshape(-1)]
    return uniq[order], pos


class _Rows:
    """One table's rows, keyed by id: the ids the steps will touch, sorted,
    are the keys; an id's slot is its place among them."""

    def __init__(self, ids: np.ndarray, dim: int, device):
        self.ids = np.unique(ids[ids != -1])
        self.seen = np.zeros(len(self.ids), bool)
        self.params = torch.zeros((len(self.ids), dim), device=device)
        self.norm = torch.zeros((len(self.ids), dim), device=device)

    def slots(self, fids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(slots of `fids`, mask of the ids not seen before)."""
        at = np.searchsorted(self.ids, fids)
        if not np.array_equal(self.ids[np.minimum(at, len(self.ids) - 1)],
                              fids):
            raise ValueError("an id outside the ids the steps touch")
        new = ~self.seen[at]
        self.seen[at] = True
        return at, new


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def run(cfg: Dict, batches: List, dense0: Dict[str, torch.Tensor],
        seed: int, device, steps: int, tf32: bool = False,
        fault: Optional[str] = None) -> Dict:
    """`steps` steps from `dense0` on `batches` [(fid_batch, batch)], with
    TF32 products if `tf32`. `fault` "half_batch" takes the loss over the
    first half of each batch only (a fault a comparison must catch).

    Returns, as float64 numpy: {"losses": [steps], "preds": [steps] of [B],
    "dense": {name: (p, acc)}, "rows": {table: (fids, vectors, norms)} over
    every id touched, after the last step; "grads1": {leaf: g} of the first
    step (dense parameters by name, "<table>.vector" rows);
    "init": {table: (fids, initial vectors)} of every admitted id}."""
    d, lr = cfg["embedding_dim"], cfg["learning_rate"]
    acc0 = cfg["accumulator_init"]
    lr_d, acc_d, eps = (cfg["dense_learning_rate"],
                        cfg["dense_accumulator_init"], cfg["dense_eps"])
    ucaps = cfg["unique_caps"]
    names = sorted(tables(cfg))
    params = {k: v.detach().clone().to(device) for k, v in dense0.items()}
    accs = {k: torch.full_like(v, acc_d) for k, v in params.items()}
    rows = {t: _Rows(np.concatenate([np.asarray(fb[t], np.int64).ravel()
                                     for fb, _ in batches[:steps]]), d,
                     device) for t in names}
    gen = torch.Generator(device=device)
    out = {"losses": [], "preds": [], "init": {t: ([], []) for t in names}}
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for step in range(steps):
            fid_batch, batch = batches[step]
            batch_t = {k: torch.from_numpy(np.asarray(v)).to(device)
                       for k, v in batch.items()}
            leaves, pooled, slots_of = {}, {}, {}
            for ti, t in enumerate(names):
                ids = np.asarray(fid_batch[t], np.int64)
                uniq, pos = dedup(ids.ravel())
                if len(uniq) > ucaps[t]:
                    raise ValueError(f"{len(uniq)} ids of {t} in a step over "
                                     f"its cap {ucaps[t]}: no step of the "
                                     f"configuration may overflow")
                sl, new = rows[t].slots(uniq)
                b = init_bound(cfg, t)
                gen.manual_seed(init_seed(seed, step, ti))
                draw = torch.rand((ucaps[t], d), generator=gen, device=device,
                                  dtype=torch.float32) * (b - -b) + -b
                sl_new = torch.from_numpy(sl[new]).to(device)
                with torch.no_grad():
                    rows[t].params[sl_new] = draw[
                        torch.from_numpy(np.nonzero(new)[0]).to(device)]
                    rows[t].norm[sl_new] = acc0
                out["init"][t][0].append(uniq[new])
                out["init"][t][1].append(_host(rows[t].params[sl_new]))
                slot_t = torch.from_numpy(sl).to(device)
                slots_of[t] = slot_t
                leaf = rows[t].params[slot_t].clone().requires_grad_()
                leaves[t] = leaf
                padded = torch.cat([leaf, leaf.new_zeros((1, d))])
                idx = torch.from_numpy(pos.reshape(ids.shape)).to(device)
                pooled[t] = padded[torch.where(idx < 0, len(uniq),
                                               idx)].sum(dim=1)
            dense_names = sorted(params)
            for n in dense_names:
                params[n].requires_grad_(True)
            logits = forward(params, pooled, batch_t, cfg)
            label = batch_t["label"]
            if fault == "half_batch":
                half = logits.shape[0] // 2
                loss = F.binary_cross_entropy_with_logits(logits[:half],
                                                          label[:half])
            else:
                loss = F.binary_cross_entropy_with_logits(logits, label)
            grads = torch.autograd.grad(
                loss, [params[n] for n in dense_names] + list(leaves.values()))
            out["losses"].append(float(loss.detach()))
            out["preds"].append(_host(torch.sigmoid(logits)))
            gd = dict(zip(dense_names, grads))
            gt = dict(zip(leaves, grads[len(dense_names):]))
            with torch.no_grad():
                for n in dense_names:
                    p = params[n].detach()
                    accs[n].add_(gd[n] * gd[n])
                    params[n] = p - lr_d * gd[n] * torch.rsqrt(accs[n] + eps)
                for t, sl in slots_of.items():
                    g = gt[t]
                    rows[t].norm[sl] += g * g
                    rows[t].params[sl] -= lr * g / torch.sqrt(rows[t].norm[sl])
            if step == 0:
                out["grads1"] = {n: _host(g) for n, g in gd.items()}
                for t, g in gt.items():
                    out["grads1"][f"{t}.vector"] = _host(g)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    out["dense"] = {n: (_host(p), _host(accs[n])) for n, p in params.items()}
    out["rows"] = {}
    for t in names:
        r = rows[t]
        keep = torch.from_numpy(np.nonzero(r.seen)[0]).to(device)
        out["rows"][t] = (r.ids[r.seen], _host(r.params[keep]),
                          _host(r.norm[keep]))
    out["init"] = {t: (np.concatenate(f), np.concatenate(v))
                   for t, (f, v) in out["init"].items()}
    return out

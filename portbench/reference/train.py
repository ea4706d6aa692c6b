"""The reference's training steps, in plain PyTorch and NumPy.

A step, as the configuration states it:

- per table, the batch's ids in first-occurrence order over the table's
  features (feature by feature, row-major; -1 is padding);
- ids seen for the first time are admitted (admission threshold 1): their
  bias starts at 0, their Adagrad accumulator at `accumulator_init`, and
  their vector at uniform(-init_scale, init_scale), the row at position j
  of the step's id list taking row j of a [unique_cap, dim] draw from a
  Philox generator seeded with (seed, step, table index): the new-row init
  keying of the configuration;
- pooling by each feature's combiner, the model's forward, the mean
  sigmoid cross-entropy, and the gradients of the dense parameters and of
  each id's row (summed over the id's occurrences);
- dense Adagrad (acc += g^2 from `dense_accumulator_init`; p -= lr * g /
  sqrt(acc + eps)), SGD on the bias (b -= lr * g), Adagrad on the vector
  (n += g^2; v -= lr * g / sqrt(n)).

`run` records what the comparison needs: each step's loss and
predictions, the first step's gradients, and the state after the last
step.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import common


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


class _Table:
    """The reference's rows of one table, keyed by id."""

    def __init__(self, dim: int, capacity: int, device):
        self.slot: Dict[int, int] = {}
        self.params = torch.zeros((capacity, 1 + dim), device=device)
        self.norm = torch.zeros((capacity, dim), device=device)

    def slots(self, fids: np.ndarray):
        """(slots of `fids`, mask of the ids not seen before); new ids get
        fresh slots, in the order given."""
        out = np.empty(len(fids), np.int64)
        new = np.zeros(len(fids), bool)
        for i, f in enumerate(fids.tolist()):
            s = self.slot.get(f)
            if s is None:
                s = self.slot[f] = len(self.slot)
                new[i] = True
            out[i] = s
        if len(self.slot) > self.params.shape[0]:
            raise ValueError("reference table capacity exceeded")
        return out, new


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().cpu().numpy()


def run(model, cfg: Dict, batches: List, dense0: Dict[str, torch.Tensor],
        seed: int, device, steps: int, tf32: bool = False,
        fault: Optional[str] = None) -> Dict:
    """`steps` reference steps from `dense0` on `batches` [(fid_batch,
    batch)]. `fault` "half_batch" takes the loss over the first half of
    each batch only (a fault the comparison must catch).

    Returns {"losses": [steps], "preds": [steps] of [B], "dense": {name:
    (p, acc)}, "rows": {table: (fids, params, norm)}, "grads1": {leaf: g},
    "init": {table: (fids, params)}} as float64 numpy: the state after
    the last step, "rows" over every id seen; the first step's gradients;
    "init" holds each admitted id's initial row."""
    d = cfg["embedding_dim"]
    lo, hi = -cfg["init_scale"], cfg["init_scale"]
    lr_v, lr_b = cfg["vector_lr"], cfg["bias_lr"]
    acc0 = cfg["accumulator_init"]
    lr_d, acc_d, eps = (cfg["dense_learning_rate"],
                        cfg["dense_accumulator_init"], cfg["dense_eps"])
    ucap = cfg["unique_cap"]
    table_feats = model.tables(cfg)
    feats = model.features(cfg)
    params = {k: v.detach().clone().to(device) for k, v in dense0.items()}
    accs = {k: torch.full_like(v, acc_d) for k, v in params.items()}
    cap = sum(np.prod(fb[f].shape) for fb, _ in batches[:steps]
              for f in feats)
    tables = {t: _Table(d, int(cap), device) for t in table_feats}
    gen = torch.Generator(device=device)
    out = {"losses": [], "preds": [], "init": {t: ([], []) for t in tables}}
    seen = {t: [] for t in tables}
    with common.matmul_precision(tf32):
        for step in range(steps):
            fid_batch, batch = batches[step]
            batch_t = {k: torch.from_numpy(np.asarray(v)).to(device)
                       for k, v in batch.items()}
            leaves, index, slots_of = {}, {}, {}
            for ti, (tname, fnames) in enumerate(sorted(table_feats.items())):
                tab = tables[tname]
                flat = np.concatenate([np.ascontiguousarray(
                    fid_batch[f], dtype=np.int64).ravel() for f in fnames])
                uniq, pos = dedup(flat)
                if len(uniq) > ucap:
                    raise ValueError(f"{len(uniq)} ids in a step over the "
                                     f"cap {ucap}: no step of the "
                                     f"configuration may overflow")
                slots, new = tab.slots(uniq)
                gen.manual_seed(init_seed(seed, step, ti))
                draw = torch.rand((ucap, d), generator=gen, device=device,
                                  dtype=torch.float32) * (hi - lo) + lo
                sl_new = torch.from_numpy(slots[new]).to(device)
                with torch.no_grad():
                    tab.params[sl_new, 0] = 0.0
                    tab.params[sl_new, 1:] = draw[
                        torch.from_numpy(np.nonzero(new)[0]).to(device)]
                    tab.norm[sl_new] = acc0
                out["init"][tname][0].append(uniq[new])
                out["init"][tname][1].append(_host(tab.params[sl_new]))
                seen[tname].append(uniq)
                sl = torch.from_numpy(slots).to(device)
                slots_of[tname] = (uniq, sl)
                leaves[tname] = tab.params[sl].clone().requires_grad_()
                index[tname] = (fnames, torch.from_numpy(pos).to(device))
            pooled = {}
            for tname, (fnames, pos) in index.items():
                P = leaves[tname]
                padded = torch.cat([P, P.new_zeros((1, P.shape[1]))])
                off = 0
                for f in fnames:
                    shape = fid_batch[f].shape
                    n = int(np.prod(shape))
                    idx = pos[off:off + n].reshape(shape)
                    off += n
                    emb = padded[torch.where(idx < 0, P.shape[0], idx)]
                    pooled[f] = common.combine(emb, idx >= 0, feats[f][1])
            names = sorted(params)
            for n in names:
                params[n].requires_grad_(True)
            logits = model.forward(params, pooled, batch_t, cfg)
            label = batch_t["label"]
            if fault == "half_batch":
                half = logits.shape[0] // 2
                loss = common.bce(logits[:half], label[:half])
            else:
                loss = common.bce(logits, label)
            grads = torch.autograd.grad(
                loss, [params[n] for n in names] + list(leaves.values()))
            out["losses"].append(float(loss.detach()))
            out["preds"].append(_host(torch.sigmoid(logits)))
            gd = dict(zip(names, grads))
            gt = dict(zip(leaves, grads[len(names):]))
            with torch.no_grad():
                for n in names:
                    p = params[n].detach()
                    accs[n].add_(gd[n] * gd[n])
                    params[n] = p - lr_d * gd[n] * torch.rsqrt(accs[n] + eps)
                for tname, (uniq, sl) in slots_of.items():
                    tab, g = tables[tname], gt[tname]
                    tab.params[sl, :1] -= lr_b * g[:, :1]
                    tab.norm[sl] += g[:, 1:] * g[:, 1:]
                    tab.params[sl, 1:] -= lr_v * g[:, 1:] / torch.sqrt(
                        tab.norm[sl])
            if step == 0:
                out["grads1"] = {n: _host(g) for n, g in gd.items()}
                for tname, g in gt.items():
                    out["grads1"][f"{tname}.bias"] = _host(g[:, :1])
                    out["grads1"][f"{tname}.vector"] = _host(g[:, 1:])
    out["dense"] = {n: (_host(p), _host(accs[n])) for n, p in params.items()}
    out["rows"] = {}
    for tname, tab in tables.items():
        fids = np.unique(np.concatenate(seen[tname]))
        slots, _ = tab.slots(fids)
        sl = torch.from_numpy(slots).to(device)
        out["rows"][tname] = (fids, _host(tab.params[sl]),
                              _host(tab.norm[sl]))
    out["init"] = {t: (np.concatenate(f), np.concatenate(v))
                   for t, (f, v) in out["init"].items()}
    return out

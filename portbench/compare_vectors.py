"""The numbers that decide `correct` for a configuration whose rows are a
vector alone (no bias segment): `compare.train_readings` with a table's
leaves the change of its vectors and the growth of their accumulator.
The names, the medians and the limits' meaning are compare.py's. A
table's leaves are reduced in float64 by torch on the host's threads
(millions of 128-wide rows a block), its states taken as they are where
both sides list the same ids in the same order."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.compare import LOSS_STEPS, _by_id, _gaps, _median_gap, _norm


def _at(fids: np.ndarray, values: np.ndarray, want: np.ndarray
        ) -> torch.Tensor:
    """values of the ids `want` (compare._by_id), as a float64 tensor."""
    if not np.array_equal(fids, want):
        values = _by_id(fids, values, want)
    return torch.from_numpy(np.asarray(values, np.float64))


def _table_norm(x: torch.Tensor) -> float:
    return float(torch.sqrt(torch.sum(torch.square(x))))


def train_readings(obs: Dict, ref: Dict, dense0: Dict[str, np.ndarray],
                   cfg: Dict, detail: Optional[Dict] = None
                   ) -> Dict[str, float]:
    """`obs`: {"losses": [K], "preds": [K] of [B], "dense": {name: (p,
    acc)}, "rows": {table: (fids, vectors, norms)}} after the block; `ref`:
    the reference's `run` result; `dense0`: the initial dense weights.
    `detail`, a dict, receives each gap's worst leaf."""
    acc_d, acc_r = cfg["dense_accumulator_init"], cfg["accumulator_init"]
    loss_gaps = [abs(o - r) / abs(r)
                 for o, r in zip(obs["losses"], ref["losses"], strict=True)]
    pred_gap = float(np.max(np.abs(obs["preds"][0] - ref["preds"][0])))

    def growth(acc, acc0):  # both sides start the accumulator in f32
        return float(np.sqrt(np.sum(acc - np.float32(acc0))))

    accum, change, rows = ({}, {}), ({}, {}), ({}, {})
    for side, state in enumerate((obs, ref)):
        for n, (p, acc) in state["dense"].items():
            accum[side][n] = growth(acc, acc_d)
            change[side][n] = _norm(p - dense0[n])
    for t, (fids_r, _, _) in ref["rows"].items():
        init_fids, init_rows = ref["init"][t]
        p0 = _at(init_fids, init_rows, fids_r)
        for side, state in enumerate((obs, ref)):
            fids, params, norm = state["rows"][t]
            moved = _table_norm(_at(fids, params, fids_r) - p0)
            grown = float(torch.sqrt(torch.sum(
                _at(fids, norm, fids_r) - float(np.float32(acc_r)))))
            change[side][f"{t}.vector"] = rows[side][f"{t}.vector"] = moved
            accum[side][f"{t}.accumulator"] = grown
            rows[side][f"{t}.accumulator"] = grown

    g_ref = {k: _norm(v) for k, v in ref["grads1"].items()}
    g_med = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    accum_gap = _median_gap(*accum, detail, "accum_gap")
    change_gap = _median_gap({k: change[0][k] for k in moved},
                             {k: change[1][k] for k in moved}, detail,
                             "change_gap")
    row_gaps = _gaps(*rows, 0.0)
    if detail is not None:
        detail["rows_gap"] = row_gaps
        detail["loss_gap"] = loss_gaps
    return {"loss_gap": max(loss_gaps[:LOSS_STEPS]), "pred_gap": pred_gap,
            "accum_gap": accum_gap, "change_gap": change_gap,
            "rows_gap": max(row_gaps.values())}

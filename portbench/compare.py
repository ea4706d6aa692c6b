"""The numbers that decide `correct`, worked out from what the program (or
whatever stands in its place) produced and from the reference.

Training, over the first block: the first `steps_per_dispatch` steps, one
call of the window's own `train_step_block`:

- `loss_gap`: the largest |loss - reference loss| / |reference loss| over
  the block's first `LOSS_STEPS` steps (the later steps' losses drift
  apart by rounding alone, 1e-7 to 6e-6 on sound runs: PERF.md; `detail`
  keeps every step's);
- `pred_gap`: the largest |prediction - reference prediction| over the
  first step's examples (the forward from the initial state: the dense
  weights the benchmark made and the rows the program drew at admission),
  as the block returned them;
- `accum_gap`: by leaf, the gradients as the optimizer got them, worked
  out from its state after the block: sqrt of the sum of the Adagrad
  accumulator's growth (dense parameters; a table's vector segment), that
  is the root of the sum over the block's steps of the squared gradient
  norms; |value - reference value| over the larger of the reference
  leaf's and the median leaf's; the median over the leaves;
- `change_gap`: the same of each leaf's change over the block (p - p0),
  leaving out the leaves whose reference first gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
- `rows_gap`: the worst of a table's leaves (bias change, vector change,
  accumulator growth), each gap over its own reference value. A table's
  leaves are norms over every id the block touched, large and steady
  from seed to seed, and two or three among a dozen dense leaves: the
  medians above cannot see a fault in the rows alone.

The two dense gaps are medians over the leaves, not the worst leaf: the
worst leaf swings from seed to seed between two sound float32 runs, by
the rounding of a small leaf's state and by the rare ReLU unit whose sign
a rounding difference flips in a later step (PERF.md). `detail` keeps the
worst leaf of each for the record.

A leaf is one dense parameter, or one segment (bias, vector, the vector's
accumulator) of one table over the ids the block touched. State is
aligned by id. Every array is float64 numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

LOSS_STEPS = 3


def _by_id(fids: np.ndarray, values: np.ndarray, want: np.ndarray
           ) -> np.ndarray:
    """values[i] of the fid want[j], for each j (every fid present)."""
    order = np.argsort(fids)
    at = order[np.searchsorted(fids[order], want)]
    if not np.array_equal(fids[at], want):
        raise ValueError("the state read back misses ids the steps touched")
    return values[at]


def _norm(x: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.square(x, dtype=np.float64))))


def _gaps(obs: Dict[str, float], ref: Dict[str, float], floor: float
          ) -> Dict[str, float]:
    return {k: abs(obs[k] - ref[k]) / max(ref[k], floor) for k in ref}


def _median_gap(obs: Dict[str, float], ref: Dict[str, float],
                detail: Optional[Dict] = None, name: str = "") -> float:
    """The median over leaves of |value - reference value| / max(reference
    value, median reference value); `detail` gets the worst leaf."""
    median = float(np.median(list(ref.values())))
    gaps = _gaps(obs, ref, median)
    if detail is not None:
        k = max(gaps, key=gaps.get)
        detail[name] = {"worst_leaf": k, "worst_gap": gaps[k],
                        "value": obs[k], "reference": ref[k],
                        "median_value": median}
    return float(np.median(list(gaps.values())))


def train_readings(obs: Dict, ref: Dict, dense0: Dict[str, np.ndarray],
                   cfg: Dict, detail: Optional[Dict] = None
                   ) -> Dict[str, float]:
    """`obs`: {"losses": [K], "preds": [K] of [B], "dense": {name: (p,
    acc)}, "rows": {table: (fids, params, norm)}} after the block; `ref`:
    `reference.train.run`'s result; `dense0`: the initial dense weights.
    `detail`, a dict, receives each gap's worst leaf."""
    acc_d, acc_r = cfg["dense_accumulator_init"], cfg["accumulator_init"]
    loss_gaps = [abs(o - r) / abs(r)
                 for o, r in zip(obs["losses"], ref["losses"], strict=True)]
    pred_gap = float(np.max(np.abs(obs["preds"][0] - ref["preds"][0])))

    def growth(acc, acc0):  # both sides start the accumulator in f32
        return float(np.sqrt(np.sum(acc - np.float32(acc0))))

    accum = ({}, {})
    change = ({}, {})
    rows = ({}, {})
    for side, state in enumerate((obs, ref)):
        for n, (p, acc) in state["dense"].items():
            accum[side][n] = growth(acc, acc_d)
            change[side][n] = _norm(p - dense0[n])
    for t, (fids_r, _, _) in ref["rows"].items():
        init_fids, init_rows = ref["init"][t]
        p0 = _by_id(init_fids, init_rows, fids_r)
        for side, state in enumerate((obs, ref)):
            fids, params, norm = state["rows"][t]
            p = _by_id(fids, params, fids_r) - p0
            n = _by_id(fids, norm, fids_r)
            leaves = {f"{t}.bias": _norm(p[:, :1]),
                      f"{t}.vector": _norm(p[:, 1:])}
            accum[side][f"{t}.accumulator"] = growth(n, acc_r)
            change[side].update(leaves)
            rows[side].update(leaves)
            rows[side][f"{t}.accumulator"] = accum[side][f"{t}.accumulator"]

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


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number compared is at or under its limit (a number
    that is not finite is over any limit)."""
    return all(np.isfinite(readings[k]) and readings[k] <= limits[k]
               for k in limits)

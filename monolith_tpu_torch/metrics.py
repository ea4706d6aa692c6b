"""Training metrics.

`device_metrics_init` / `device_metrics_update` keep loss and AUC
histograms as tensors on the device, updated in place every step, so the
host reads them only when results are wanted (`Trainer._drain_metrics`).
`StreamingAUC` (a fixed-bucket thresholded AUC, the estimator tf.metrics.auc
uses) and `StreamingMean` are host-side numpy accumulators.
"""

from __future__ import annotations

import numpy as np
import torch


def device_metrics_init(num_thresholds: int, device):
    """Zeroed on-device metric state: AUC histograms + loss accumulator."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return {"pos": z(num_thresholds), "neg": z(num_thresholds),
            "loss_sum": z(), "loss_weight": z()}


@torch.no_grad()
def device_metrics_update(state, loss, preds=None, labels=None):
    """In-place update: accumulate loss (a scalar or a [K] block of
    per-step losses) and bucket preds into the AUC histograms; with preds
    or labels None, the loss alone. Returns state."""
    loss = loss.detach()
    state["loss_sum"] += loss.sum().float()
    state["loss_weight"] += float(max(loss.numel(), 1))
    if preds is None or labels is None:
        return state
    T = state["pos"].shape[0]
    p = torch.clamp(preds.detach().reshape(-1).float(), 0.0, 1.0)
    y = labels.reshape(-1).float()
    b = torch.clamp((p * T).to(torch.int32), max=T - 1).long()
    state["pos"].index_add_(0, b, y)
    state["neg"].index_add_(0, b, 1.0 - y)
    return state


class StreamingAUC:
    """Thresholded ROC-AUC accumulator over minibatches."""

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = num_thresholds
        # bucket b counts predictions in [b/N, (b+1)/N)
        self.pos_hist = np.zeros(num_thresholds, dtype=np.float64)
        self.neg_hist = np.zeros(num_thresholds, dtype=np.float64)

    def update(self, preds, labels, weights=None) -> None:
        preds = np.clip(np.asarray(preds, dtype=np.float64).ravel(), 0.0, 1.0)
        labels = np.asarray(labels, dtype=np.float64).ravel()
        w = (np.ones_like(labels) if weights is None
             else np.asarray(weights, np.float64).ravel())
        buckets = np.minimum((preds * self.num_thresholds).astype(np.int64),
                             self.num_thresholds - 1)
        np.add.at(self.pos_hist, buckets, labels * w)
        np.add.at(self.neg_hist, buckets, (1.0 - labels) * w)

    def update_histograms(self, pos_hist, neg_hist) -> None:
        """Fold in already-bucketed counts (the device-metrics drain path)."""
        pos_hist = np.asarray(pos_hist, np.float64)
        if pos_hist.shape != self.pos_hist.shape:
            raise ValueError(f"histogram shape {pos_hist.shape} != "
                             f"{self.pos_hist.shape}")
        self.pos_hist += pos_hist
        self.neg_hist += np.asarray(neg_hist, np.float64)

    def result(self) -> float:
        total_pos = self.pos_hist.sum()
        total_neg = self.neg_hist.sum()
        if total_pos == 0 or total_neg == 0:
            return 0.5
        # sweep threshold from high to low: TPR/FPR curve, trapezoid rule
        tp = np.cumsum(self.pos_hist[::-1])
        fp = np.cumsum(self.neg_hist[::-1])
        tpr = np.concatenate([[0.0], tp / total_pos])
        fpr = np.concatenate([[0.0], fp / total_neg])
        return float(np.trapezoid(tpr, fpr))

    def reset(self) -> None:
        self.pos_hist[:] = 0
        self.neg_hist[:] = 0


class StreamingMean:
    def __init__(self):
        self.total = 0.0
        self.count = 0.0

    def update(self, value, weight: float = 1.0) -> None:
        self.total += float(value) * weight
        self.count += weight

    def result(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        self.total = self.count = 0.0


def auc(preds, labels) -> float:
    """One-shot exact AUC (rank statistic, ties averaged)."""
    preds = np.asarray(preds).ravel()
    labels = np.asarray(labels).ravel()
    order = np.argsort(preds, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(preds) + 1)
    sorted_preds = preds[order]
    i = 0
    while i < len(sorted_preds):
        j = i
        while j + 1 < len(sorted_preds) and sorted_preds[j + 1] == sorted_preds[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels > 0.5].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))

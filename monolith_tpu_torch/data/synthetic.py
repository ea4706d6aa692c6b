"""Synthetic CTR data with learnable latent structure (numpy).

Users/items have latent vectors; click probability = sigmoid(<u, v> * scale
+ user bias + item bias). The same seed gives the same batches as the JAX
package's `SyntheticCTR`, so the two packages train on identical data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticCTR:
    num_users: int = 5000
    num_items: int = 2000
    latent_dim: int = 8
    batch_size: int = 256
    history_length: int = 10   # user click history as a sequence feature
    seed: int = 0
    logit_scale: float = 3.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.user_vecs = rng.normal(size=(self.num_users, self.latent_dim)) / np.sqrt(self.latent_dim)
        self.item_vecs = rng.normal(size=(self.num_items, self.latent_dim)) / np.sqrt(self.latent_dim)
        self.user_bias = 0.3 * rng.normal(size=self.num_users)
        self.item_bias = 0.3 * rng.normal(size=self.num_items)
        self._rng = rng
        # popular items for plausible histories
        self._pop = rng.zipf(1.3, size=self.num_items * 4) % self.num_items

    # fid encoding: slot id in high bits (ref fid.h:22 v1 slot = fid>>54)
    USER_SLOT = 1 << 54
    ITEM_SLOT = 2 << 54
    HIST_SLOT = 3 << 54

    def batch(self) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        rng = self._rng
        B = self.batch_size
        u = rng.integers(0, self.num_users, size=B)
        v = rng.integers(0, self.num_items, size=B)
        logits = (np.einsum("bd,bd->b", self.user_vecs[u], self.item_vecs[v])
                  * self.logit_scale + self.user_bias[u] + self.item_bias[v])
        p = 1.0 / (1.0 + np.exp(-logits))
        label = (rng.random(B) < p).astype(np.float32)
        hist = rng.choice(self._pop, size=(B, self.history_length))
        hist_len = rng.integers(1, self.history_length + 1, size=B)
        hist_fids = np.where(np.arange(self.history_length)[None, :] < hist_len[:, None],
                             hist + self.HIST_SLOT, -1)
        fid_batch = {
            "user_id": (u + self.USER_SLOT).astype(np.int64)[:, None],
            "item_id": (v + self.ITEM_SLOT).astype(np.int64)[:, None],
            "hist_items": hist_fids.astype(np.int64),
        }
        batch = {"label": label,
                 "hist_len": hist_len.astype(np.int32)}
        return fid_batch, batch

    def __iter__(self) -> Iterator:
        while True:
            yield self.batch()

    def bayes_auc(self, n: int = 50000) -> float:
        """AUC of the true click probability — the generator's ceiling."""
        from monolith_tpu_torch.metrics import auc
        rng = np.random.default_rng(self.seed + 1)
        u = rng.integers(0, self.num_users, size=n)
        v = rng.integers(0, self.num_items, size=n)
        logits = (np.einsum("bd,bd->b", self.user_vecs[u], self.item_vecs[v])
                  * self.logit_scale + self.user_bias[u] + self.item_bias[v])
        p = 1.0 / (1.0 + np.exp(-logits))
        label = (rng.random(n) < p).astype(np.float32)
        return auc(p, label)

"""Per-channel item pools for in-stream negative generation.

The port's copy (numpy and stdlib) of the JAX package's rebuild of the
reference's item-pool machinery
(data/kernels/item_pool_kernels.cc create/random_fill/save/restore,
datasets.py:740 NegativeGenDataset, item_pool_hook.py save/restore hook):
a reservoir of recently-seen items per channel; `negative_gen` swaps a
positive example's item features for pool samples to synthesize negatives.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from monolith_tpu_torch.data.example import Example


class ItemPool:
    """Reservoir-sampled pool of item feature-bundles, keyed by channel id."""

    def __init__(self, max_items_per_channel: int = 1024, seed: int = 0):
        self.max_items = max_items_per_channel
        self._rng = np.random.default_rng(seed)
        # channel -> list of {feature_name: int64 array}
        self._pools: Dict[int, List[Dict[str, np.ndarray]]] = {}
        self._seen: Dict[int, int] = {}

    def add(self, channel: int, item_features: Dict[str, np.ndarray]) -> None:
        pool = self._pools.setdefault(channel, [])
        seen = self._seen.get(channel, 0)
        if len(pool) < self.max_items:
            pool.append(item_features)
        else:  # reservoir sampling keeps a uniform sample of the stream
            j = int(self._rng.integers(0, seen + 1))
            if j < self.max_items:
                pool[j] = item_features
        self._seen[channel] = seen + 1

    def sample(self, channel: int, n: int) -> List[Dict[str, np.ndarray]]:
        pool = self._pools.get(channel, [])
        if not pool:
            return []
        idx = self._rng.integers(0, len(pool), size=n)
        return [pool[i] for i in idx]

    def size(self, channel: Optional[int] = None) -> int:
        if channel is not None:
            return len(self._pools.get(channel, []))
        return sum(len(p) for p in self._pools.values())

    # --- save/restore (ref item_pool save/restore kernels) ---

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta = {}
        arrays = {}
        for ch, pool in self._pools.items():
            meta[str(ch)] = [{k: f"{ch}/{i}/{k}" for k in item}
                             for i, item in enumerate(pool)]
            for i, item in enumerate(pool):
                for k, v in item.items():
                    arrays[f"{ch}/{i}/{k}"] = v
        np.savez(path + ".npz", **arrays)
        with open(path + ".json", "w") as f:
            json.dump({"meta": meta, "seen": {str(k): v for k, v in self._seen.items()},
                       "max_items": self.max_items}, f)

    def restore(self, path: str) -> None:
        with open(path + ".json") as f:
            data = json.load(f)
        z = np.load(path + ".npz")
        self._pools = {}
        for ch_s, items in data["meta"].items():
            ch = int(ch_s)
            self._pools[ch] = [{k: z[key] for k, key in item.items()}
                               for item in items]
        self._seen = {int(k): v for k, v in data["seen"].items()}
        self.max_items = data["max_items"]


def negative_gen(source: Iterable[Example], pool: ItemPool,
                 item_features: Sequence[str], neg_num: int,
                 per_channel: bool = False,
                 negative_label: float = 0.0,
                 label_index: int = 0,
                 pool_add_positives_only: bool = True,
                 seed: int = 0) -> Iterator[Example]:
    """For each positive example, also emit `neg_num` negatives whose item
    features are swapped with pool samples (ref datasets.py:740 negative_gen).
    Positives feed the pool as they stream by."""
    for ex in source:
        ch = int(ex.line_id.chnid) if per_channel else 0
        is_pos = len(ex.labels) > label_index and ex.labels[label_index] > 0
        if is_pos or not pool_add_positives_only:
            pool.add(ch, {k: np.asarray(ex.features.get(k, np.empty(0, np.int64)))
                          for k in item_features})
        yield ex
        if not is_pos:
            continue
        for sampled in pool.sample(ch, neg_num):
            neg_feats = dict(ex.features)
            neg_feats.update(sampled)
            labels = ex.labels.copy()
            labels[label_index] = negative_label
            yield Example(features=neg_feats, dense=dict(ex.dense),
                          labels=labels, instance_weight=ex.instance_weight,
                          line_id=ex.line_id)

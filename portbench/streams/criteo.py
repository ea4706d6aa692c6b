"""The Criteo stream of the DeepFM configuration: one id a field for each
of the configuration's fields (13 bucketed integer fields and 26
categorical ones, DeepFM's 39), each drawn from a power law (a bounded
Zipf, rank = id) over that field's vocabulary, and a click label drawn at
the data's share of clicks.

Batch i is drawn from (seed, i) alone, so that batches can be made ahead,
in parallel, and batch i does not depend on the batches before it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SLOT_SHIFT = 54   # fid = (field index + 1) << 54 | id


def power_law(rng, vocab: int, exponent: float, n: int) -> np.ndarray:
    """`n` ids in [0, vocab): the floor of a continuous power law x **
    -exponent on [1, vocab + 1) drawn by the inverse of its CDF, less 1,
    so P(id = k) is its mass on [k + 1, k + 2), about (k + 1.5) **
    -exponent (exponent > 1)."""
    a = 1.0 - exponent
    x = ((vocab + 1.0) ** a - 1.0) * rng.random(n) + 1.0
    return np.minimum(np.floor(x ** (1.0 / a)) - 1.0, vocab - 1).astype(
        np.int64)


class World:
    """What every batch of one seed shares."""

    def __init__(self, cfg: Dict, seed: int):
        self.fields = dict(cfg["fields"])
        self.exponent = cfg["power_law_exponent"]
        self.positive_rate = cfg["positive_rate"]
        self.seed = seed % (1 << 64)

    def batch(self, i: int, batch_size: int
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Training batch i: ({field: int64 [B, 1]}, {"label": f32 [B]})."""
        rng = np.random.default_rng([self.seed, 1, i])
        fid_batch = {}
        for f, (name, vocab) in enumerate(self.fields.items()):
            ids = power_law(rng, vocab, self.exponent, batch_size)
            fid_batch[name] = (ids + ((f + 1) << SLOT_SHIFT))[:, None]
        label = (rng.random(batch_size) < self.positive_rate).astype(
            np.float32)
        return fid_batch, {"label": label}

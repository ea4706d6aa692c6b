"""The multi-hot Criteo 1TB stream of the DLRM-DCNv2 configuration: for
each of the configuration's 26 features a bag of `multi_hot_sizes[i]` ids,
each id drawn on its own from a power law (a bounded Zipf, rank = id) over
the rows this card holds of the feature's table (`criteo.power_law`); 13
dense values, each a long-tailed count x = floor(exp(N(mean, sd^2))) sent
as log(1 + x); and a click label drawn at the configuration's share of
clicks.

Batch i is drawn from (seed, i) alone, so that batches can be made ahead,
in parallel, and batch i does not depend on the batches before it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench.reference import dlrm_dcnv2 as model
from portbench.streams.criteo import power_law


class World:
    """What every batch of one seed shares."""

    def __init__(self, cfg: Dict, seed: int):
        self.rows = model.held_rows(cfg)
        self.hotness = dict(zip(model.feature_names(cfg),
                                cfg["multi_hot_sizes"]))
        self.exponent = cfg["power_law_exponent"]
        self.positive_rate = cfg["positive_rate"]
        self.num_dense = cfg["num_dense"]
        self.dense_mean, self.dense_sd = cfg["dense_log_count"]
        self.seed = seed % (1 << 64)

    def batch(self, i: int, batch_size: int
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Training batch i: ({feature: int64 [B, L]}, {"dense": f32 [B,
        13], "label": f32 [B]})."""
        rng = np.random.default_rng([self.seed, 2, i])
        fid_batch = {}
        for name, n in self.hotness.items():
            fid_batch[name] = power_law(rng, self.rows[name], self.exponent,
                                        batch_size * n).reshape(batch_size, n)
        counts = np.floor(np.exp(rng.normal(self.dense_mean, self.dense_sd,
                                            (batch_size, self.num_dense))))
        label = (rng.random(batch_size) < self.positive_rate).astype(
            np.float32)
        return fid_batch, {"dense": np.log1p(counts).astype(np.float32),
                           "label": label}

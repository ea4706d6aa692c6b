"""Capacity auto-sizing from data samples.

The port's copy (numpy) of the JAX package's module. The engine's
per-step buffers are STATIC (the wire and the gathers have fixed shapes): each
table needs a `unique_cap` >= the deduped ids it sees per step, padded up
front rather than grown dynamically. The reference sizes these through
config files tuned per model (feature_list slot lines, `max_ids_per_chip`
knobs); production models with dozens of slots tune per-table caps by
hand — PERF.md's multislot record shows mis-sized caps either overflow
(dropped ids) or waste gather/scatter width. This helper measures real
batches and recommends caps with headroom.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


def measure_unique_counts(batches: Iterable[Dict[str, np.ndarray]],
                          table_features: Dict[str, List[str]],
                          num_shards: int = 1) -> Dict[str, int]:
    """Max per-step (per-shard, worst shard) unique-id count per table.

    batches: an iterable of fid_batch dicts {feature: [B, L] int64, -1 pad}.
    table_features: {table: [feature names]} (engine.table_features values'
    `.name`s, or task-level mapping).
    """
    worst: Dict[str, int] = {}
    for fb in batches:
        for tname, feats in table_features.items():
            vals = [np.asarray(fb[f]).ravel() for f in feats if f in fb]
            if not vals:
                continue
            flat = np.concatenate(vals)
            flat = flat[flat != -1]
            u = np.unique(flat)
            if num_shards > 1:
                # exact worst shard under the REAL routing hash (mt_shard_of
                # — the same C++ mix the dedup uses), not an approximation:
                # an under-provisioned cap silently drops overflowed ids
                from monolith_tpu_torch.embedding.host_store import shard_of_batch
                shards = shard_of_batch(u, num_shards)
                m = int(np.bincount(shards, minlength=num_shards).max())
            else:
                m = len(u)
            worst[tname] = max(worst.get(tname, 0), m)
    return worst


def suggest_caps(batches: Iterable[Dict[str, np.ndarray]],
                 table_features: Dict[str, List[str]],
                 num_shards: int = 1,
                 headroom: float = 1.25,
                 compact_wire_limit: Optional[int] = 65535
                 ) -> Dict[str, int]:
    """Per-table unique_cap recommendation: measured worst step x headroom,
    rounded up to a multiple of 128 (the JAX package's rule, so that both
    packages suggest the same caps). Caps above `compact_wire_limit` (the int16
    wire index range) are flagged by raising — pass None to disable when
    using the int32 multi-array path.

    Use with EngineConfig: unique_caps=tuple(suggest_caps(...).items()).
    """
    out = {}
    for tname, m in measure_unique_counts(batches, table_features,
                                          num_shards).items():
        cap = int(np.ceil(m * headroom / 128.0) * 128)
        cap = max(cap, 128)
        if compact_wire_limit is not None and cap > compact_wire_limit:
            raise ValueError(
                f"table {tname!r} needs unique_cap ~{cap} which exceeds the "
                f"compact-wire int16 index range ({compact_wire_limit}); "
                f"shard the table, merge fewer slots, or use the int32 "
                f"path (compact_wire_limit=None)")
        out[tname] = cap
    return out

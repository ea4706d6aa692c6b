"""Merging same-config tables (the port's copy of the JAX package's merge).

Tables whose configs are identical are merged into ONE physical table, so
the engine runs one gather and one scatter per step for all of them; a
mapping records where each original table landed. Correct only when the
tables' features use slot-encoded fids (disjoint id spaces), as the
synthetic data does.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Sequence, Tuple

from monolith_tpu_torch.embedding.spec import TableSpec
from monolith_tpu_torch.embedding.table import _layout
from monolith_tpu_torch.feature import FeatureConfig


def _config_key(spec: TableSpec) -> str:
    """Stable digest of everything except name and capacity: segments,
    admission, eviction, pool dtype and stochastic rounding."""
    payload = repr((spec.segments, spec.admission, spec.eviction,
                    str(spec.dtype), spec.stochastic_rounding))
    return hashlib.md5(payload.encode()).hexdigest()[:12]


def merge_table_specs(specs: Sequence[TableSpec],
                      features: Sequence[FeatureConfig],
                      max_group_bytes: int = 0
                      ) -> Tuple[List[TableSpec], List[FeatureConfig],
                                 Dict[str, str]]:
    """Group identically-configured tables into merged tables.

    Returns (merged specs, features remapped to merged tables,
    {original table name: merged table name}). Capacities add up.

    `max_group_bytes` > 0 caps each merged pool's size (padded row bytes x
    summed capacity): members are first-fit binned, largest first, so no
    merged pool exceeds the cap; 0 merges without limit."""
    groups: Dict[str, List[TableSpec]] = {}
    for spec in specs:
        groups.setdefault(_config_key(spec), []).append(spec)

    mapping: Dict[str, str] = {}
    merged: List[TableSpec] = []
    for key, members in groups.items():
        if len(members) == 1:
            merged.append(members[0])
            mapping[members[0].name] = members[0].name
            continue
        bins: List[List[TableSpec]] = [members]
        if max_group_bytes > 0:
            row_bytes = (_layout(members[0])[1]
                         * members[0].dtype.itemsize)
            bins, sizes = [], []
            for m in sorted(members, key=lambda s: -s.capacity_per_shard):
                b = m.capacity_per_shard * row_bytes
                for i, used in enumerate(sizes):
                    if used + b <= max_group_bytes:
                        bins[i].append(m)
                        sizes[i] += b
                        break
                else:
                    bins.append([m])
                    sizes.append(b)
        for gi, group in enumerate(bins):
            if len(group) == 1 and len(bins) > 1:
                merged.append(group[0])
                mapping[group[0].name] = group[0].name
                continue
            name = "merged_" + key + (f"_{gi}" if len(bins) > 1 else "")
            cap = sum(m.capacity_per_shard for m in group)
            merged.append(dataclasses.replace(group[0], name=name,
                                              capacity_per_shard=cap))
            for m in group:
                mapping[m.name] = name

    new_features = [dataclasses.replace(f, table=mapping[f.table])
                    for f in features]
    return merged, new_features, mapping

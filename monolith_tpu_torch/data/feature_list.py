"""Feature-list config file: named features, slots, and extraction metadata.

The port's copy (stdlib) of the JAX package's rebuild of ref
data/feature_list.py (Feature :87, FeatureList :200, FeatureList.parse
:264). Same on-disk format:

    # comment
    column_name: user, item, context
    cache_column: some_col
    feature_name=f_user_id slot=1 method=DirectString depend=user occurrence_threshold=3
    feature_name=fc_clicks-fc_item slot=200 method=Combine depend=clicks,item args=a,b

Each non-header line is a series of `key=value` terms separated by spaces
(values may contain commas for lists). Lookup accepts the bare name with or
without the reference's `f_` / `fc_` prefixes, or the slot number.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

_BOOL = {"true", "yes", "t", "y", "1"}


def _split_list(v: Optional[str]) -> Optional[List[str]]:
    if v is None:
        return None
    return [t.strip().strip("\"'") for t in v.split(",") if t.strip()]


@dataclasses.dataclass
class Feature:
    """One extraction-config line (ref feature_list.py:87)."""
    feature_name: str = ""
    slot: Optional[int] = None
    method: Optional[str] = None
    depend: Optional[List[str]] = None
    args: Optional[List[str]] = None
    feature_version: Optional[int] = None
    shared: bool = False
    need_raw: bool = False
    feature_id: Optional[int] = None
    occurrence_threshold: Optional[int] = None
    expire_time: Optional[int] = None
    max_seq_len: Optional[int] = None
    extra: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        """Normalized name: strips the reference's f_/fc_ prefixes per term
        (ref feature_list.py:172)."""
        terms = []
        for term in self.feature_name.split("-"):
            if term.startswith("fc_"):
                term = term[3:]
            elif term.startswith("f_"):
                term = term[2:]
            terms.append(term)
        return "-".join(terms)

    @classmethod
    def from_params(cls, params: Dict[str, str]) -> "Feature":
        known = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        kw, extra = {}, {}
        for k, v in params.items():
            if k in known:
                kw[k] = v
            else:
                extra[k] = v
        f = cls(extra=extra, **{k: v for k, v in kw.items()
                                if k in ("feature_name",)})
        for k, v in kw.items():
            if k == "feature_name":
                continue
            if k in ("slot", "feature_version", "feature_id",
                     "occurrence_threshold", "expire_time", "max_seq_len"):
                setattr(f, k, int(v))
            elif k in ("shared", "need_raw"):
                setattr(f, k, str(v).lower() in _BOOL)
            elif k in ("depend", "args"):
                setattr(f, k, _split_list(v))
            else:
                setattr(f, k, v)
        return f


def _parse_terms(line: str) -> Dict[str, str]:
    """Parse `k1=v1 k2=v2 ...` where values may contain commas/spaces up to
    the next ` key=` (the reference's rindex-based splitter, :292)."""
    params: Dict[str, str] = {}
    items = line.split("=")
    keys: List[str] = []
    for i in range(len(items) - 1):
        if i == 0:
            keys.append(items[i].strip())
        else:
            start = items[i].rindex(" ")
            keys.append(items[i][start:].strip())
    for i, key in enumerate(keys):
        raw = items[i + 1]
        if i == len(keys) - 1:
            value = raw.strip()
        else:
            end = raw.rindex(" ")
            value = raw[:end].strip()
        params[key] = value
    return params


class FeatureList:
    """Parsed feature-list file with name/slot lookup (ref :200)."""

    def __init__(self, features: Dict[str, Feature],
                 column_name: Optional[set] = None,
                 cache_columns: Sequence[str] = ()):
        self.features = features
        self.column_name = column_name
        self.cache_columns = list(cache_columns)
        self._slots: Dict[int, List[Feature]] = {}
        for f in features.values():
            if f.slot is not None:
                self._slots.setdefault(f.slot, []).append(f)

    def __len__(self):
        return len(self.features)

    def __iter__(self):
        return iter(self.features.values())

    def __contains__(self, item):
        try:
            self[item]
            return True
        except KeyError:
            return False

    def __getitem__(self, item) -> Feature:
        if isinstance(item, int):
            if item in self._slots:
                return self._slots[item][0]
            raise KeyError(f"no feature with slot {item}")
        item = item.strip()
        for cand in (item, f"f_{item}", f"fc_{item}",
                     "-".join(f"fc_{t}" for t in item.split("-")),
                     "-".join(f"f_{t}" for t in item.split("-"))):
            if cand in self.features:
                return self.features[cand]
        raise KeyError(f"no feature '{item}'")

    def get(self, item, default=None):
        try:
            return self[item]
        except KeyError:
            return default

    def get_with_slot(self, slot: int) -> List[Feature]:
        return self._slots.get(slot, [])

    @classmethod
    def parse(cls, fname: str) -> "FeatureList":
        column_name = None
        cache_columns: List[str] = []
        features: Dict[str, Feature] = {}
        with open(fname) as stream:
            for line in stream:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("column_name"):
                    column_name = {t.strip()
                                   for t in line[len("column_name:"):].split(",")}
                    continue
                if line.startswith("cache_column"):
                    cache_columns.append(line[len("cache_column:"):].strip())
                    continue
                params = _parse_terms(line)
                if "feature_name" not in params:
                    continue
                f = Feature.from_params(params)
                features[f.feature_name] = f
        return cls(features, column_name, cache_columns)

    # -- bridge to the engine's declarative feature configs --------------

    def to_feature_configs(self, table: str = "sparse",
                           default_max_length: int = 1,
                           combiner: str = "sum"):
        """Build engine FeatureConfigs: sequence features (max_seq_len set)
        get the firstn combiner; slot-encoded fid spaces stay collisionless
        through the host store, so no vocab sizes are needed."""
        from monolith_tpu_torch.feature import FeatureConfig
        out = []
        for f in self:
            if f.max_seq_len:
                out.append(FeatureConfig(name=f.name, table=table,
                                         max_length=f.max_seq_len,
                                         combiner="firstn"))
            else:
                out.append(FeatureConfig(name=f.name, table=table,
                                         max_length=default_max_length,
                                         combiner=combiner))
        return out

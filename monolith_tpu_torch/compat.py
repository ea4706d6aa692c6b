"""Reference-style user API: FeatureSlot / FeatureColumn / slice lookups,
the port of the JAX package's compat.py.

A drop-in surface for users coming from the reference's imperative feature
API (FeatureSlot feature.py:102, FeatureColumn :176, FeatureSlotConfig :78;
MonolithModel.create_embedding_feature_column native_model.py:911,
lookup_embedding_slice :977, share_slot :1086). The reference collects
these calls during a dry-run graph build; here the SAME call sequence
builds the declarative `TableSpec`/`FeatureConfig` set that the engine
compiles, so existing model code ports line by line:

    fm = compat.FeatureFactory()
    fc_user = fm.create_embedding_feature_column("fc_user",
                                                  occurrence_threshold=2)
    fc_hist = fm.create_embedding_feature_column("fc_hist",
                                                  max_seq_length=20)
    vec = fc_user.feature_slot.add_feature_slice(16)
    bias = fc_user.feature_slot.get_bias_slice()
    ...
    tables, features = fm.build()
    # inside the task's nn.Module:
    u = compat.lookup_embedding_slice(pooled, fc_user, vec)   # [B, 16]

Deliberate differences: slices are (start, end) views of the merged table
row (same as the reference); there is no dry run — `build()` returns the
specs directly; combiners are the framework's {"sum","mean","firstn"}.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from monolith_tpu_torch.embedding import (compressors, initializers,
                                          optimizers)
from monolith_tpu_torch.embedding.spec import (AdmissionConfig,
                                               EvictionConfig, TableSegment,
                                               TableSpec)
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.ops.insight import feature_insight, fid_counter
from monolith_tpu_torch.ops.interactions import ffm_interaction

DEFAULT_EXPIRE_TIME = 36500 * 24 * 3600  # ~100 years, ref DEFAULT_EXPIRE_TIME


@dataclasses.dataclass
class FeatureSlotConfig:
    """ref feature.py:78 — per-slot table defaults."""
    name: Optional[str] = None
    slot_id: Optional[int] = None
    has_bias: bool = False
    bias_initializer: initializers.Initializer = dataclasses.field(
        default_factory=initializers.Zeros)
    bias_optimizer: optimizers.RowOptimizer = dataclasses.field(
        default_factory=lambda: optimizers.Ftrl(
            initial_accumulator_value=1e-6, beta=1.0))
    default_vec_initializer: initializers.Initializer = dataclasses.field(
        default_factory=initializers.RandomUniform)
    default_vec_optimizer: optimizers.RowOptimizer = dataclasses.field(
        default_factory=lambda: optimizers.Adagrad(
            initial_accumulator_value=1.0))
    default_vec_compressor: compressors.Compressor = dataclasses.field(
        default_factory=compressors.Fp16)
    capacity: int = 1 << 20
    occurrence_threshold: int = 0
    expire_time: int = DEFAULT_EXPIRE_TIME  # seconds without update

    def __post_init__(self):
        if not self.name:
            self.name = str(self.slot_id)


@dataclasses.dataclass(frozen=True)
class FeatureSlice:
    """A [start, end) view of a slot's merged row (ref feature.py:65)."""
    feature_slot: "FeatureSlot"
    start: int
    end: int

    @property
    def dim(self) -> int:
        return self.end - self.start


class FeatureSlot:
    """User-facing hash table: a sequence of embedding slices with their
    own optimizer/initializer/compressor (ref feature.py:102)."""

    def __init__(self, config: FeatureSlotConfig):
        self.config = config
        self._segments: List[TableSegment] = []
        self._dim = 0
        self._bias_slice: Optional[FeatureSlice] = None
        if config.has_bias:
            self._bias_slice = self.add_feature_slice(
                1, initializer=config.bias_initializer,
                optimizer=config.bias_optimizer)

    def add_feature_slice(self, dim_size: int,
                          initializer=None, optimizer=None, compressor=None,
                          learning_rate_fn: Optional[Callable] = None
                          ) -> FeatureSlice:
        cfg = self.config
        seg = TableSegment(
            dim=dim_size,
            optimizer=optimizer or cfg.default_vec_optimizer,
            initializer=initializer or cfg.default_vec_initializer,
            compressor=compressor or cfg.default_vec_compressor,
            lr_schedule=learning_rate_fn)
        self._segments.append(seg)
        s = FeatureSlice(self, self._dim, self._dim + dim_size)
        self._dim += dim_size
        return s

    def get_bias_slice(self) -> FeatureSlice:
        assert self.config.has_bias, "slot built without has_bias"
        return self._bias_slice

    def build_table_spec(self) -> TableSpec:
        cfg = self.config
        admission = (AdmissionConfig(kind="sliding",
                                     threshold=cfg.occurrence_threshold)
                     if cfg.occurrence_threshold > 1 else AdmissionConfig())
        return TableSpec(name=cfg.name, capacity_per_shard=cfg.capacity,
                         segments=tuple(self._segments),
                         admission=admission,
                         eviction=EvictionConfig(
                             ttl_seconds=cfg.expire_time
                             if cfg.expire_time < DEFAULT_EXPIRE_TIME else 0))


class FeatureColumn:
    """Links an input feature to a slot (ref feature.py:176)."""

    @classmethod
    def reduce_sum(cls) -> str:
        return "sum"

    @classmethod
    def reduce_mean(cls) -> str:
        return "mean"

    @classmethod
    def first_n(cls, seq_length: int) -> Tuple[str, int]:
        return ("firstn", seq_length)

    def __init__(self, feature_slot: FeatureSlot, feature_name: str,
                 combiner="sum", max_length: int = 1):
        self.feature_slot = feature_slot
        self.feature_name = feature_name
        if isinstance(combiner, tuple):  # first_n(seq_length)
            combiner, max_length = combiner[0], combiner[1]
        self.combiner = combiner
        self.max_length = max_length

    def embedding_lookup(self, pooled: Dict, s: FeatureSlice):
        """Model-time slice of this column's pooled embedding (ref
        FeatureColumn.embedding_lookup / lookup_embedding_slice,
        native_model.py:977). Works for pooled [B, D] and sequence
        [B, L, D] outputs alike."""
        assert s.feature_slot is self.feature_slot, \
            "slice must come from this column's feature slot"
        return pooled[self.feature_name][..., s.start:s.end]


def lookup_embedding_slice(pooled: Dict, fc: FeatureColumn, s: FeatureSlice):
    """Free-function spelling of FeatureColumn.embedding_lookup (ref
    MonolithModel.lookup_embedding_slice, native_model.py:977)."""
    return fc.embedding_lookup(pooled, s)


class FeatureFactory:
    """Collects slots/columns the way MonolithModel does, then `build()`s
    the declarative specs (ref create_embedding_feature_column
    native_model.py:911 + share_slot :1086 via `shared_name`)."""

    def __init__(self, default_capacity: int = 1 << 20):
        self.default_capacity = default_capacity
        self.slots: Dict[str, FeatureSlot] = {}
        self.columns: Dict[str, FeatureColumn] = {}

    def create_feature_slot(self, config: FeatureSlotConfig) -> FeatureSlot:
        if config.name in self.slots:
            return self.slots[config.name]
        fs = FeatureSlot(config)
        self.slots[config.name] = fs
        return fs

    def create_embedding_feature_column(
            self, feature_name: str,
            occurrence_threshold: Optional[int] = None,
            expire_time: int = DEFAULT_EXPIRE_TIME,
            max_seq_length: int = 0,
            shared_name: Optional[str] = None,
            combiner: Optional[str] = None,
            has_bias: bool = False,
            capacity: Optional[int] = None) -> FeatureColumn:
        if feature_name in self.columns:
            return self.columns[feature_name]
        if shared_name is not None:
            if shared_name in self.slots:
                fs = self.slots[shared_name]
            elif shared_name in self.columns:
                fs = self.columns[shared_name].feature_slot
            else:
                raise ValueError(
                    f"{feature_name} shares embedding with {shared_name}, "
                    f"so {shared_name} must be created first")
        else:
            fs = self.create_feature_slot(FeatureSlotConfig(
                name=feature_name, has_bias=has_bias,
                occurrence_threshold=occurrence_threshold or 0,
                expire_time=expire_time,
                capacity=capacity or self.default_capacity))
        if combiner is None:
            combiner = ("firstn", max_seq_length) if max_seq_length > 0 \
                else "sum"
        elif combiner in ("reduce_sum", "sum"):
            combiner = "sum"
        elif combiner in ("reduce_mean", "mean"):
            combiner = "mean"
        elif combiner in ("first_n", "firstn"):
            combiner = ("firstn", max(max_seq_length, 1))
        fc = FeatureColumn(fs, feature_name, combiner=combiner,
                           max_length=max_seq_length or 1)
        self.columns[feature_name] = fc
        return fc

    def build(self) -> Tuple[List[TableSpec], List[FeatureConfig]]:
        """The specs the engine/trainer consume. Call after every
        add_feature_slice (slices define the table rows)."""
        used = {fc.feature_slot.config.name for fc in self.columns.values()}
        tables = [fs.build_table_spec() for name, fs in self.slots.items()
                  if name in used]
        features = [FeatureConfig(name=fc.feature_name,
                                  table=fc.feature_slot.config.name,
                                  max_length=fc.max_length,
                                  combiner=fc.combiner)
                    for fc in self.columns.values()]
        return tables, features


class layer_ops:
    """Namespace shim mirroring `monolith.native_training.layers.layer_ops`
    (ref layer_ops.py): reference model code using `layer_ops.ffm`,
    `layer_ops.feature_insight`, or `layer_ops.fid_counter` ports with only
    the import changed. Each member is the port's implementation
    (ops/interactions.py, ops/insight.py)."""

    @staticmethod
    def ffm(left, right, dim_size, int_type: str = "multiply"):
        return ffm_interaction(left, right, dim_size, int_type)

    @staticmethod
    def feature_insight(input_embedding, weight, segment_sizes,
                        aggregate: bool = False):
        return feature_insight(input_embedding, weight, segment_sizes,
                               aggregate)

    @staticmethod
    def fid_counter(counter, counter_threshold, step=1.0):
        return fid_counter(counter, counter_threshold, step)

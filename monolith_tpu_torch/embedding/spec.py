"""Declarative table specs (the port's copy of the frozen dataclasses).

A `TableSpec` is a merged table: one row pool whose row vector is the
concatenation of `segments`, each with its own dim, optimizer and
initializer. The port carries the subset its slice runs: f32 pools, the
`Constant` learning-rate schedule, no compressors, no expiry (the engine
rejects a table with a ttl).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from monolith_tpu_torch.embedding.initializers import Initializer, RandomUniform
from monolith_tpu_torch.embedding.optimizers import RowOptimizer, SGD


@dataclasses.dataclass(frozen=True)
class Constant:
    """Constant learning rate (ref learning_rate_functions.py)."""
    value: float = 0.01

    def __call__(self, step: int) -> float:
        return self.value


@dataclasses.dataclass(frozen=True)
class TableSegment:
    """One slice of a table row: its own dim/optimizer/initializer.
    `retriever` is declared for parity with the JAX spec; the port's slice
    runs none and the engine rejects a segment that sets one."""
    dim: int
    optimizer: RowOptimizer = dataclasses.field(default_factory=SGD)
    initializer: Initializer = dataclasses.field(default_factory=RandomUniform)
    lr_schedule: Optional[Constant] = None
    retriever: Optional[object] = None

    def learning_rate(self, step: int) -> float:
        if self.lr_schedule is not None:
            return self.lr_schedule(step)
        return self.optimizer.learning_rate


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Frequency-based feature admission: "none", "sliding" (count-min
    window, admits at `threshold`), "probabilistic" or
    "probabilistic_unequal"."""
    kind: str = "none"
    threshold: int = 1
    filter_capacity: int = 0
    filter_splits: int = 5


@dataclasses.dataclass(frozen=True)
class EvictionConfig:
    """Time-based expiry (0 = never evict)."""
    ttl_seconds: int = 0


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """A merged embedding table: one fid space, one device row pool."""
    name: str
    capacity_per_shard: int
    segments: Tuple[TableSegment, ...]
    admission: AdmissionConfig = dataclasses.field(default_factory=AdmissionConfig)
    eviction: EvictionConfig = dataclasses.field(default_factory=EvictionConfig)

    @property
    def dim(self) -> int:
        return sum(s.dim for s in self.segments)

    @property
    def segment_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for s in self.segments:
            offs.append(acc)
            acc += s.dim
        return tuple(offs)

"""Declarative table specs (the port's copy of the frozen dataclasses).

A `TableSpec` is a merged table: one row pool whose row vector is the
concatenation of `segments`, each with its own dim, optimizer and
initializer, serving compressor and (optionally) retriever. The port
carries what it runs: f32 or bf16 pools (bf16 optionally with
stochastic rounding on write-back), the three learning-rate schedules, the
per-segment compressors of a serving export, the quantization-aware
retrievers and time-based expiry (`EvictionConfig.ttl_seconds`).

A schedule is called with the trainer's step number, a Python int that the
host knows, and returns a Python float. The JAX package's schedules take a
traced int32 and compute in f32; the port's compute in numpy f32 in the same
operation order, so the two agree to an f32 ulp.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from monolith_tpu_torch.embedding.compressors import Compressor, Fp32
from monolith_tpu_torch.embedding.initializers import Initializer, RandomUniform
from monolith_tpu_torch.embedding.optimizers import RowOptimizer, SGD


@dataclasses.dataclass(frozen=True)
class LearningRateSchedule:
    def __call__(self, step: int) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(LearningRateSchedule):
    """Constant learning rate (ref learning_rate_functions.py)."""
    value: float = 0.01

    def __call__(self, step: int) -> float:
        return self.value


@dataclasses.dataclass(frozen=True)
class PolynomialDecay(LearningRateSchedule):
    """lr decays from initial to end over decay_steps with the given power;
    with `cycle` the decay restarts over the next multiple of decay_steps
    instead of holding the end value (tf PolynomialDecay's rule)."""
    initial_learning_rate: float = 0.01
    decay_steps: int = 10000
    end_learning_rate: float = 0.0001
    power: float = 1.0
    cycle: bool = False

    def __call__(self, step: int) -> float:
        f32 = np.float32
        step = f32(step)
        if self.cycle:
            mult = max(f32(1.0), np.ceil(step / f32(self.decay_steps)))
            decay_steps = f32(self.decay_steps) * mult
        else:
            decay_steps = f32(self.decay_steps)
            step = min(step, decay_steps)
        frac = f32(1.0) - step / decay_steps
        span = f32(self.initial_learning_rate - self.end_learning_rate)
        return float(span * np.power(frac, f32(self.power))
                     + f32(self.end_learning_rate))


@dataclasses.dataclass(frozen=True)
class WarmupSchedule(LearningRateSchedule):
    """Linear warmup over the first warmup_steps steps, wrapped around
    another schedule: lr * min(1, (step + 1) / warmup_steps)."""
    base: LearningRateSchedule = dataclasses.field(default_factory=Constant)
    warmup_steps: int = 0

    def __call__(self, step: int) -> float:
        lr = self.base(step)
        if self.warmup_steps <= 0:
            return lr
        f32 = np.float32
        scale = min(f32(1.0), (f32(step) + f32(1.0)) / f32(self.warmup_steps))
        return float(f32(lr) * scale)


@dataclasses.dataclass(frozen=True)
class TableSegment:
    """One slice of a table row: its own dim/optimizer/initializer and
    serving compressor (applied at export). `retriever`
    (embedding/retrievers.py) turns on quantization-aware retrieval of this
    slice in training; export and the streaming push bake it in."""
    dim: int
    optimizer: RowOptimizer = dataclasses.field(default_factory=SGD)
    initializer: Initializer = dataclasses.field(default_factory=RandomUniform)
    compressor: Compressor = dataclasses.field(default_factory=Fp32)
    lr_schedule: Optional[LearningRateSchedule] = None
    retriever: Optional["Retriever"] = None  # embedding.retrievers

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
    dtype: torch.dtype = torch.float32
    # narrow optimized rows to a bf16 pool stochastically (K3) instead of
    # to nearest; requires dtype=torch.bfloat16
    stochastic_rounding: bool = False

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"table {self.name}: pools are float32 or "
                             f"bfloat16 (got {self.dtype})")
        if self.stochastic_rounding and self.dtype != torch.bfloat16:
            raise ValueError(f"table {self.name}: stochastic_rounding needs "
                             f"a bfloat16 pool (got {self.dtype})")

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

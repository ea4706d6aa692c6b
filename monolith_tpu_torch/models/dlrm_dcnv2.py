"""DLRM with a DCN V2 interaction, as MLPerf Training runs it on Criteo 1TB
with multi-hot features (mlcommons/training recommendation_v2/
torchrec_dlrm; Wang et al., "DCN V2", arXiv:2008.13535).

The dense inputs ([B, 13] float32 in `batch["dense"]`, already log(1 + x))
go through a bottom MLP (512-256-128, ReLU after every layer). Each of the
26 sparse features is a sum-pooled bag of `hotness` ids on a table of its
own, 128 wide. The concatenation [bottom | 26 bags] (27 x 128 = 3456)
goes through 3 low-rank cross layers of rank 512 (layers/cross.py
`LowRankCross`) and a top MLP of 1024-1024-512-256-1; the loss is the mean
sigmoid cross-entropy. Rows and tower train with Adagrad.

Spans (utils/tracing.py) inside the trainer's `step.forward`: `step.bottom`,
`step.cross` (the concatenation and the cross layers) and `step.top`. The
module names the submodules they wrap in `graph_parts`, which the trainer
captures as CUDA graphs one by one (training/graphs.py), so that each
replay runs inside its span.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.cross import LowRankCross
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.optimizers.dense import Adagrad
from monolith_tpu_torch.training.task import RecTask
from monolith_tpu_torch.utils.tracing import span

#: MLPerf's Criteo 1TB tables: rows of each of the 26 features
MLPERF_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
               40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
               40000000, 40000000, 40000000, 590152, 12973, 108, 36)
#: MLPerf's multi-hot sizes: ids a bag of each feature
MLPERF_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                  12, 100, 27, 10, 3, 1, 1)


class DLRMDCNv2Module(nn.Module):
    """The dense tower over the pooled bags of `feature_names` (each [B,
    embedding_dim]) and `batch["dense"]` [B, num_dense]."""

    #: the submodules that the forward's spans wrap, in the order they run
    graph_parts = ("bottom", "cross", "top")

    def __init__(self, feature_names: Sequence[str], embedding_dim: int = 128,
                 num_dense: int = 13, bottom: Sequence[int] = (512, 256, 128),
                 top: Sequence[int] = (1024, 1024, 512, 256, 1),
                 cross_layers: int = 3, cross_rank: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_names = tuple(feature_names)
        self.bottom = MLP(num_dense, tuple(bottom), generator=generator,
                          activate_last=True)
        width = bottom[-1] + len(self.feature_names) * embedding_dim
        self.cross = LowRankCross(width, cross_layers, cross_rank,
                                  generator=generator)
        self.top = MLP(width, tuple(top), generator=generator)

    def forward(self, pooled: Dict[str, torch.Tensor], batch
                ) -> Dict[str, torch.Tensor]:
        with span("step.bottom"):
            x = self.bottom(batch["dense"])
        with span("step.cross"):
            x = self.cross(torch.cat(
                [x] + [pooled[f] for f in self.feature_names], dim=1))
        with span("step.top"):
            logits = self.top(x)[:, 0]
        return {"logits": logits}


@dataclasses.dataclass
class DLRMDCNv2Task(RecTask):
    """One table a feature, `C1` .. `C26`: table i holds `rows[i]` rows and
    is read by a bag of `hotness[i]` ids. Rows are [vector (dim, Adagrad
    from `accumulator_init`)], drawn at admission from uniform(-b, b) with
    b = sqrt(1 / init_rows[i]) (torchrec's init; `init_rows` defaults to
    `rows`: a table held in part keeps its whole table's bound). The tower
    trains with the port's Adagrad (optax's form) at `learning_rate`."""
    name: str = "dlrm_dcnv2"
    rows: Tuple[int, ...] = MLPERF_ROWS
    hotness: Tuple[int, ...] = MLPERF_HOTNESS
    init_rows: Optional[Tuple[int, ...]] = None
    embedding_dim: int = 128
    num_dense: int = 13
    bottom: Sequence[int] = (512, 256, 128)
    top: Sequence[int] = (1024, 1024, 512, 256, 1)
    cross_layers: int = 3
    cross_rank: int = 512
    learning_rate: float = 0.004
    accumulator_init: float = 0.1
    table_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.rows) != len(self.hotness):
            raise ValueError(f"{len(self.rows)} tables and "
                             f"{len(self.hotness)} hotness values")

    @property
    def feature_names(self) -> Tuple[str, ...]:
        return tuple(f"C{i + 1}" for i in range(len(self.rows)))

    def tables(self):
        init_rows = self.init_rows or self.rows
        out = []
        for name, rows, n in zip(self.feature_names, self.rows, init_rows):
            bound = math.sqrt(1.0 / n)
            seg = TableSegment(
                dim=self.embedding_dim,
                optimizer=optimizers.Adagrad(
                    learning_rate=self.learning_rate,
                    initial_accumulator_value=self.accumulator_init),
                initializer=initializers.RandomUniform(-bound, bound))
            out.append(TableSpec(name=name, capacity_per_shard=rows,
                                 segments=(seg,), dtype=self.table_dtype))
        return out

    def features(self):
        return [FeatureConfig(name=name, table=name, max_length=n,
                              combiner="sum")
                for name, n in zip(self.feature_names, self.hotness)]

    def build_module(self, generator=None):
        return DLRMDCNv2Module(self.feature_names,
                               embedding_dim=self.embedding_dim,
                               num_dense=self.num_dense,
                               bottom=tuple(self.bottom), top=tuple(self.top),
                               cross_layers=self.cross_layers,
                               cross_rank=self.cross_rank,
                               generator=generator)

    def dense_optimizer(self) -> Adagrad:
        return Adagrad(learning_rate=self.learning_rate)

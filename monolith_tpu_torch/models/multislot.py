"""Many-slot CTR task: N tables, dozens of sparse slots, one DIN-attended
click-history sequence (the JAX package's second bench config).

Layout: `num_slots` scalar features assigned round-robin onto `num_tables`
tables, plus a history sequence on its own table pooled with "firstn" and
attended against slot_0's vector (DIN). Each table row = [1-dim SGD bias |
dim-dim Adagrad vector]. With `merge=True` the identically-configured
tables collapse into one physical table, `table_all`, so the engine runs
one gather and one scatter per step for all of them. bf16 pools
(`table_dtype`), stochastic rounding of their write-back and a bf16 dense
tower (`dense_dtype`) are the bench's bf16 variant.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.embedding import initializers, optimizers
from monolith_tpu_torch.embedding.merge import merge_table_specs
from monolith_tpu_torch.embedding.spec import TableSegment, TableSpec
from monolith_tpu_torch.feature import FeatureConfig
from monolith_tpu_torch.layers.feature_seq import DIN
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.training.task import RecTask


class MultiSlotModule(nn.Module):
    """Dense side: the slots' bias terms, DIN over the history against
    slot_0, and the deep tower over [slot vectors | attention]. Parameter
    names are flax's (`din.dense_tower.dense_i`, `deep.dense_i`)."""

    def __init__(self, embedding_dim: int = 16,
                 hidden: Sequence[int] = (256, 128, 64),
                 num_slots: int = 40, history_length: int = 20,
                 dense_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_slots = num_slots
        self.history_length = history_length
        self.din = DIN(embedding_dim, history_length, generator=generator)
        self.deep = MLP((num_slots + 1) * embedding_dim, (*hidden, 1),
                        generator=generator, compute_dtype=dense_dtype)

    def forward(self, pooled: Dict[str, torch.Tensor], batch
                ) -> Dict[str, torch.Tensor]:
        d = self.embedding_dim
        bias = 0.0
        vecs = []
        for s in range(self.num_slots):
            e = pooled[f"slot_{s}"]
            bias = bias + e[:, 0]
            vecs.append(e[:, 1:1 + d])
        seq = pooled["hist_items"]            # [B, L, 1+d] (firstn)
        positions = torch.arange(self.history_length, device=seq.device)
        mask = positions[None, :] < batch["hist_len"][:, None]
        att = self.din(vecs[0], seq[:, :, 1:1 + d], mask=mask)
        deep = self.deep(torch.cat(vecs + [att], dim=-1))[:, 0]
        return {"logits": bias + deep}


@dataclasses.dataclass
class MultiSlotTask(RecTask):
    name: str = "multislot"
    num_tables: int = 16
    num_slots: int = 40
    embedding_dim: int = 16
    capacity_per_shard: int = 1 << 18
    history_length: int = 20
    hidden: Sequence[int] = (256, 128, 64)
    vector_lr: float = 0.5
    bias_lr: float = 0.5
    init_scale: float = 0.05
    table_dtype: torch.dtype = torch.float32
    stochastic_rounding: bool = False
    dense_dtype: Optional[torch.dtype] = None
    # merge the identically-configured tables into one physical table
    merge: bool = False
    # cap each merged pool's bytes (first-fit binning); 0 = one pool
    merge_max_bytes: int = 0

    def _segments(self):
        return (
            TableSegment(dim=1,
                         optimizer=optimizers.SGD(learning_rate=self.bias_lr),
                         initializer=initializers.Zeros()),
            TableSegment(dim=self.embedding_dim,
                         optimizer=optimizers.Adagrad(
                             learning_rate=self.vector_lr,
                             initial_accumulator_value=0.01),
                         initializer=initializers.RandomUniform(
                             -self.init_scale, self.init_scale)),
        )

    def _raw(self):
        names = [f"table_{t}" for t in range(self.num_tables)] + ["table_hist"]
        specs = [TableSpec(name=n, capacity_per_shard=self.capacity_per_shard,
                           segments=self._segments(), dtype=self.table_dtype,
                           stochastic_rounding=self.stochastic_rounding)
                 for n in names]
        feats = [FeatureConfig(name=f"slot_{s}",
                               table=f"table_{s % self.num_tables}",
                               max_length=1, combiner="sum")
                 for s in range(self.num_slots)]
        feats.append(FeatureConfig(name="hist_items", table="table_hist",
                                   max_length=self.history_length,
                                   combiner="firstn"))
        if not self.merge:
            return specs, feats
        specs, feats, _ = merge_table_specs(
            specs, feats, max_group_bytes=self.merge_max_bytes)
        # stable names: one merged table is `table_all`, several bins
        # `table_all_<i>`
        m_names = sorted(s.name for s in specs if s.name.startswith("merged_"))
        rename = ({m_names[0]: "table_all"} if len(m_names) == 1 else
                  {n: f"table_all_{i}" for i, n in enumerate(m_names)})
        specs = [dataclasses.replace(s, name=rename.get(s.name, s.name))
                 for s in specs]
        feats = [dataclasses.replace(f, table=rename.get(f.table, f.table))
                 for f in feats]
        return specs, feats

    def _built(self):
        # tables() and features() must come from one spec build + merge
        if "_raw_cache" not in self.__dict__:
            self.__dict__["_raw_cache"] = self._raw()
        return self.__dict__["_raw_cache"]

    def tables(self):
        return self._built()[0]

    def features(self):
        return self._built()[1]

    def build_module(self, generator=None):
        return MultiSlotModule(embedding_dim=self.embedding_dim,
                               hidden=tuple(self.hidden),
                               num_slots=self.num_slots,
                               history_length=self.history_length,
                               dense_dtype=self.dense_dtype,
                               generator=generator)

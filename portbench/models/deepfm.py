"""The program's DeepFM over the configuration's fields, built through
the port's public API: its `DeepFMTask` (tables, row optimizers, dense
optimizer) with one single-id feature a field, and its `DeepFMModule`
over those fields."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


def build_task(cfg: Dict):
    from monolith_tpu_torch.feature import FeatureConfig
    from monolith_tpu_torch.models.deepfm import DeepFMModule, DeepFMTask

    @dataclasses.dataclass
    class FieldsDeepFMTask(DeepFMTask):
        fields: Tuple[str, ...] = ()

        def features(self):
            return [FeatureConfig(name=n, table="sparse", max_length=1,
                                  combiner="sum") for n in self.fields]

        def build_module(self, generator=None):
            return DeepFMModule(embedding_dim=self.embedding_dim,
                                hidden=tuple(self.hidden),
                                feature_names=self.fields,
                                dense_dtype=self.dense_dtype,
                                generator=generator)

    return FieldsDeepFMTask(embedding_dim=cfg["embedding_dim"],
                            capacity_per_shard=cfg["capacity_per_shard"],
                            hidden=tuple(cfg["hidden"]),
                            vector_lr=cfg["vector_lr"],
                            bias_lr=cfg["bias_lr"],
                            init_scale=cfg["init_scale"],
                            accumulator_init=cfg["accumulator_init"],
                            table_dtype=getattr(torch, cfg["table_dtype"]),
                            fields=tuple(cfg["fields"]))

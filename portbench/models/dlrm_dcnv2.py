"""The program's DLRM-DCNv2 over the configuration's tables, built through
the port's public API: its `DLRMDCNv2Task` (one table a feature, row and
tower Adagrad) at the configuration's widths, held rows and init bounds."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import dlrm_dcnv2 as model


def build_task(cfg: Dict):
    from monolith_tpu_torch.models.dlrm_dcnv2 import DLRMDCNv2Task
    if cfg["learning_rate"] != cfg["dense_learning_rate"]:
        raise ValueError("the task trains rows and tower at one rate")
    names = model.feature_names(cfg)
    held = model.held_rows(cfg)
    return DLRMDCNv2Task(
        rows=tuple(held[n] for n in names),
        hotness=tuple(cfg["multi_hot_sizes"]),
        init_rows=tuple(cfg["num_embeddings_per_feature"]),
        embedding_dim=cfg["embedding_dim"], num_dense=cfg["num_dense"],
        bottom=tuple(cfg["bottom_mlp"]), top=tuple(cfg["top_mlp"]),
        cross_layers=cfg["cross_layers"], cross_rank=cfg["cross_rank"],
        learning_rate=cfg["learning_rate"],
        accumulator_init=cfg["accumulator_init"],
        table_dtype=getattr(torch, cfg["table_dtype"]))

"""The DLRM-DCNv2 cell cut to a size the CPU runs in seconds, for the
tests: the same files, every table and hotness kept, tables cut to at
most 2000 rows but C21 (200,000 rows, a unique cap of 70000: the wide
wire), dim 16, towers 32-16 and 32-16-1, rank 8, batch 128."""

from __future__ import annotations

import copy
from typing import Dict

from portbench import run
from portbench.reference import dlrm_dcnv2 as model

CELL = "dcnv2_criteo1tb.train"
TRAFFIC = dict(batches=16, generator_threads=2, trace_blocks=2)


def files(cell: str = CELL) -> Dict:
    f = copy.deepcopy(run.cell_files(cell))
    cfg = f["cfg"]
    for k in [k for k in cfg if k.startswith("rows_")]:
        del cfg[k]
    rows = [min(r, 2000) for r in cfg["num_embeddings_per_feature"]]
    rows[20] = 200_000
    cfg.update(num_embeddings_per_feature=rows, embedding_dim=16,
               bottom_mlp=[32, 16], top_mlp=[32, 16, 1], cross_rank=8,
               batch_size=128)
    cfg["unique_caps"] = {n: min(h, 4096)
                          for n, h in model.held_rows(cfg).items()}
    cfg["unique_caps"]["C21"] = 70000
    f["traffic"].update(TRAFFIC)
    return f


def execute(seed: int = (1 << 35) + 7, seconds: float = 1.0,
            trace: bool = False) -> Dict:
    return run.execute(CELL, seed, seconds, trace, device="cpu",
                       files=files(), log=lambda s: None)

"""The cell of the benchmark cut to a size the CPU runs in seconds, for
the tests: the same files, with the sizes below in place of the card's
(every field kept, its vocabulary cut to at most 1000 ids; the caps kept,
so that the steps run in blocks as on the card)."""

from __future__ import annotations

import copy
from typing import Dict

from portbench import run

CELL = "deepfm_criteo.train"
TRAFFIC = dict(batches=16, generator_threads=2, trace_blocks=2)


def sizes(cfg: Dict) -> Dict:
    fields = {n: min(v, 1000) for n, v in cfg["fields"].items()}
    return dict(fields=fields, capacity_per_shard=sum(fields.values()),
                batch_size=256, hidden=[32, 16])


def files(cell: str = CELL) -> Dict:
    """`run.cell_files(cell)` with the small sizes."""
    f = copy.deepcopy(run.cell_files(cell))
    f["cfg"].update(sizes(f["cfg"]))
    f["traffic"].update(TRAFFIC)
    return f


def execute(cell: str = CELL, seed: int = 11, seconds: float = 1.0,
            trace: bool = False) -> Dict:
    return run.execute(cell, seed, seconds, trace, device="cpu",
                       files=files(cell), log=lambda s: None)

"""The yardstick of the rooflines and of the step's share of the peak.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at
its 700 W limit): 67 TFLOP/s in float32 outside the tensor cores, which is
where the configurations' float32 towers run with TF32 off, and 3.35 TB/s
of HBM. A card of another name has no peak here, and the metrics that
need one are left out.

A step's FLOPs are counted from the configuration's widths by the
reference model's `train_flops_per_example`. A row kernel's bytes are the
bytes its work needs, not what a layout moves: each valid row read once
and written once, at the width of the state the table's segments declare
(the parameters and their optimizer slots, in the pool's dtype), so the
count stays the same whatever row layout the program picks.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {"NVIDIA H100 80GB HBM3": {"f32_flops": 67e12,
                                   "bytes_per_s": 3.35e12}}

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def peak(device_kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_kind)


def row_state_bytes(cfg: Dict) -> int:
    """Bytes of one id's state: a 1-wide SGD bias (no slot) and a
    `embedding_dim`-wide Adagrad vector (one accumulator of its width)."""
    d = cfg["embedding_dim"]
    return (1 + d + d) * _ITEMSIZE[cfg["table_dtype"]]


def row_kernel_bytes(valid_rows: float, cfg: Dict) -> float:
    """Bytes a gather or a scatter of `valid_rows` rows needs: each read
    once and written once."""
    return valid_rows * 2 * row_state_bytes(cfg)

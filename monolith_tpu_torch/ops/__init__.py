"""The port's ops, with the JAX package's names; and its kernels: K1/K2
(ops/scatter.py) and K3 (ops/rounding.py). Each kernel wrapper counts its
launches in `<wrapper>.launches`."""

from __future__ import annotations

from typing import Callable, Dict

from monolith_tpu_torch.ops.clip import clip_by_global_norm, global_norm
from monolith_tpu_torch.ops.insight import feature_insight, fid_counter
from monolith_tpu_torch.ops.interactions import (dot_interaction,
                                                 ffm_interaction,
                                                 fm_interaction)
from monolith_tpu_torch.ops.seq import gen_seq_mask


def kernel_wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of the port, by name."""
    from monolith_tpu_torch.ops import rounding, scatter
    return {"gather_rows": scatter.gather_rows,
            "scatter_rows": scatter.scatter_rows,
            "stochastic_round_bf16": rounding.stochastic_round_bf16}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}

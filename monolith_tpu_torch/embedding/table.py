"""Device-resident embedding table: the packed row pool.

Each id's full state is one row of a single `[capacity, P]` pool of
`spec.dtype` (f32 or bf16):

    [ seg0 params | seg1 params | ... | seg0 slots | seg1 slots | pad ]

with P padded to a multiple of 128 columns. The column order and the pad
are the JAX package's (`monolith_tpu/embedding/table.py::_layout`), so a
table state converts one to one; the pad is a TPU tiling rule kept for that
reason, not measured on the card.

Row indices are assigned by the host `HostStore`; init, gather, per-segment
optimize and scatter run on the device. Rows = -1 (filtered / padded) read
zeros and drop their writes. The one gather and the one scatter of a step
are the K1/K2 kernels (ops/scatter.py).

A bf16 pool stores the same packed row in half the bytes (256 B a row at
P = 128). All row math (init, optimize) runs in f32 on the gathered rows:
`gather_packed` widens after K1, and `scatter_packed` narrows before K2,
stochastically (K3, ops/rounding.py) when `spec.stochastic_rounding` is
set and a seed is given, to nearest otherwise. Optimizer slots are 16-bit
too in such a pool, as in the JAX package's packed layout.

State is `{"data": [cap, P]}` for one shard (the port runs single-shard
tables; the JAX package's states carry a leading shard axis). Unlike the
JAX program, which donates the pool to each step, the port updates it in
place: `scatter_packed` writes into the pool tensor.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from monolith_tpu_torch.embedding.spec import TableSpec
from monolith_tpu_torch.ops.rounding import stochastic_round_bf16
from monolith_tpu_torch.ops.scatter import gather_rows, scatter_rows

TableState = Dict[str, torch.Tensor]

_LANES = 128


@functools.lru_cache(maxsize=None)
def _layout(spec: TableSpec):
    """Column layout of a packed row: (width, padded, slot_offsets) where
    slot_offsets[(seg_idx, name)] = (offset, k, init_value). Params occupy
    [0, dim) in segment order; slots follow in (segment, sorted-name)
    order."""
    off = spec.dim
    slots = {}
    for i, seg in enumerate(spec.segments):
        for name, (k, init_value) in sorted(seg.optimizer.slot_spec(seg.dim).items()):
            slots[(i, name)] = (off, k, init_value)
            off += k
    width = off
    padded = max(_LANES, -(-width // _LANES) * _LANES)
    return width, padded, slots


def create_state(spec: TableSpec, device) -> TableState:
    """Allocate the pool in `spec.dtype`: zeros, with slot columns at their
    init value (rounded to nearest in a bf16 pool: 0.01 is stored as
    0.010009765625, as in the JAX package)."""
    _, padded, slots = _layout(spec)
    data = torch.zeros((spec.capacity_per_shard, padded), dtype=spec.dtype,
                       device=device)
    for (_, _name), (off, k, init_value) in slots.items():
        if init_value != 0.0:
            data[:, off:off + k] = init_value
    return {"data": data}


def init_packed(spec: TableSpec, generator: torch.Generator, n: int,
                device) -> torch.Tensor:
    """Fresh packed rows [n, P]: per-segment initializer values for params,
    slot init values, zero padding."""
    _, padded, slots = _layout(spec)
    row = torch.zeros((n, padded), dtype=torch.float32, device=device)
    off = 0
    for seg in spec.segments:
        row[:, off:off + seg.dim] = seg.initializer.init(
            generator, (n, seg.dim), device)
        off += seg.dim
    for (_i, _name), (o, k, init_value) in slots.items():
        if init_value != 0.0:
            row[:, o:o + k] = init_value
    return row


def gather_packed(spec: TableSpec, state: TableState,
                  rows: torch.Tensor) -> torch.Tensor:
    """Gather full packed rows [n, P] as f32; -1 rows read zeros (inside
    K1). A bf16 pool is widened after the gather."""
    return gather_rows(state["data"], rows).float()


def scatter_packed(spec: TableSpec, state: TableState, rows: torch.Tensor,
                   values: torch.Tensor, seed: Optional[int] = None
                   ) -> TableState:
    """Write full packed rows in place; -1 rows dropped (K2). THE one
    scatter per step. f32 values are narrowed to a bf16 pool
    stochastically (K3, with `seed`) when spec.stochastic_rounding is set
    and a seed is given; to nearest otherwise (init, assign, restore of
    values that were never wider)."""
    pool = state["data"]
    if values.dtype != pool.dtype:
        if spec.stochastic_rounding and seed is not None:
            values = stochastic_round_bf16(values, seed)
        else:
            values = values.to(pool.dtype)
    scatter_rows(pool, rows, values)
    return state


def params_of(spec: TableSpec, packed: torch.Tensor) -> torch.Tensor:
    """Params columns of gathered packed rows."""
    return packed[..., :spec.dim]


def optimize_packed(spec: TableSpec, packed: torch.Tensor,
                    grads: torch.Tensor, step: int,
                    stale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pure row math: apply each segment's optimizer to gathered packed
    rows. Returns new packed rows; the caller scatters them once.

    `stale`: in the 1-step-stale asynchronous block, the packed rows the
    forward used. A segment whose optimizer has `stale_apply` (DC) receives
    its columns of them to compensate the gradient; every other segment
    ignores them."""
    _, _, slot_offs = _layout(spec)
    new_p, new_slots = [], {}
    off = 0
    for i, seg in enumerate(spec.segments):
        g_seg = grads[..., off:off + seg.dim]
        p_seg = packed[..., off:off + seg.dim]
        gathered = {}
        for name in seg.optimizer.slot_spec(seg.dim):
            o, k, _ = slot_offs[(i, name)]
            gathered[name] = packed[..., o:o + k]
        lr = seg.learning_rate(step)
        if stale is not None and hasattr(seg.optimizer, "stale_apply"):
            p_new, slots_new = seg.optimizer.stale_apply(
                p_seg, gathered, g_seg, lr, step,
                stale[..., off:off + seg.dim])
        else:
            p_new, slots_new = seg.optimizer.apply(p_seg, gathered, g_seg,
                                                   lr, step)
        new_p.append(p_new)
        for name, val in slots_new.items():
            new_slots[(i, name)] = val
        off += seg.dim
    out = packed.clone()
    out[..., :spec.dim] = torch.cat(new_p, dim=-1)
    for (i, name), val in new_slots.items():
        o, k, _ = slot_offs[(i, name)]
        out[..., o:o + k] = val
    return out


def lookup(spec: TableSpec, state: TableState,
           rows: torch.Tensor) -> torch.Tensor:
    """Gather rows ([n] int32, -1 -> zeros) as [n, dim] f32."""
    return params_of(spec, gather_packed(spec, state, rows))


def params_np(spec: TableSpec, state: TableState) -> np.ndarray:
    """[cap, dim] params of a table state, f32 on the host."""
    return state["data"][:, :spec.dim].float().cpu().numpy()

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

A second kind of state, `{"params": [cap, dim], "slots": []}`, is what a
serving replica holds: params only, rows `spec.dim` wide. `lookup`,
`assign_rows` and `params_np` take either kind; on such a state they are
plain PyTorch (`index_select`, `index_copy_`), as the JAX package's are
plain XLA: its rows (68 bytes for DeepFM) are no whole number of 16-byte
vectors, which K1 and K2 move. Training never builds one.

The host accessors (`params_np`, `slot_items_np`, `state_from_np`) are what
checkpoint reads and writes; they work on a state whose tensors live on the
card or on the host (a live prefix copied back).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

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


def _valid_rows(rows: torch.Tensor, cap: int) -> torch.Tensor:
    return (rows >= 0) & (rows < cap)


def lookup(spec: TableSpec, state: TableState,
           rows: torch.Tensor) -> torch.Tensor:
    """Gather rows ([n] int32; -1 and rows beyond the pool -> zeros) as
    [n, dim] f32. K1 on a packed state; `index_select` on clamped rows and
    a mask on a structure-of-arrays state."""
    if "data" in state:
        return params_of(spec, gather_packed(spec, state, rows))
    pool = state["params"]
    valid = _valid_rows(rows, pool.shape[0])
    out = pool.index_select(0, torch.where(valid, rows, 0).long())
    return torch.where(valid[:, None], out, 0).float()


def assign_rows(spec: TableSpec, state: TableState, rows: torch.Tensor,
                values: torch.Tensor) -> TableState:
    """Directly write embedding values [n, dim] into `rows` (unique; -1 and
    rows beyond the pool drop), in place: a delta restore or a parameter
    push. On a packed state: K1, overwrite the first `dim` columns, K2 (the
    optimizer slots keep what they held)."""
    if "data" in state:
        packed = gather_packed(spec, state, rows)
        packed[:, :spec.dim] = values.float()
        return scatter_packed(spec, state, rows, packed)
    pool = state["params"]
    valid = _valid_rows(rows, pool.shape[0])
    pool.index_copy_(0, rows[valid].long(), values[valid].to(pool.dtype))
    return state


def params_np(spec: TableSpec, state: TableState) -> np.ndarray:
    """[n, dim] params of a table state (either kind), f32 on the host."""
    pool = state["data"][:, :spec.dim] if "data" in state else state["params"]
    return pool.cpu().float().numpy()


def slot_items_np(spec: TableSpec, state: TableState
                  ) -> List[Tuple[str, np.ndarray]]:
    """[('seg{i}/{name}', [n, k]), ...] of a packed state, f32 on the host,
    in (segment, sorted name) order."""
    data = state["data"].cpu().float().numpy()
    slot_offs = _layout(spec)[2]
    out = []
    for i, seg in enumerate(spec.segments):
        for name in sorted(seg.optimizer.slot_spec(seg.dim)):
            off, k, _ = slot_offs[(i, name)]
            out.append((f"seg{i}/{name}", data[:, off:off + k]))
    return out


def state_from_np(spec: TableSpec, pool: np.ndarray,
                  slots: Dict[str, np.ndarray], device) -> TableState:
    """Build a packed device state from host arrays: pool [h, dim], slots
    {'seg{i}/{name}': [h, k]} with h <= capacity (a checkpoint's live
    prefix). Rows from h up are what `create_state` gives a fresh pool
    (params zero, slots at their init value) and are made on the device, so
    only the h rows cross; a slot missing from `slots` starts at its init
    value. Values narrow to a bf16 pool with a plain cast, exact for values
    that came from one."""
    h = pool.shape[0]
    if h > spec.capacity_per_shard:
        raise ValueError(f"table {spec.name}: {h} rows do not fit "
                         f"capacity_per_shard {spec.capacity_per_shard}")
    _, padded, slot_offs = _layout(spec)
    state = create_state(spec, device)
    prefix = np.zeros((h, padded), np.float32)
    prefix[:, :spec.dim] = pool
    for (i, name), (off, k, init_value) in slot_offs.items():
        prefix[:, off:off + k] = slots.get(f"seg{i}/{name}", init_value)
    state["data"][:h] = torch.from_numpy(prefix).to(device).to(spec.dtype)
    return state

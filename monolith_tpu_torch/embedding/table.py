"""Device-resident embedding table: the packed row pool, or one array a
parameter and optimizer slot.

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

The structure-of-arrays state (`create_state(..., packed=False)`, the
engine's `packed="off"`, and any table whose dtype is neither f32 nor
bf16) is the JAX package's other layout:

    {"params": [cap, dim] spec.dtype,
     "slots":  [{name: [cap, k] f32} for each segment]}

so a bf16 table keeps f32 optimizer accumulators. Its rows are read with
`index_select` and written with `index_copy_` (`_read_rows`,
`_write_rows`), plain PyTorch as the JAX package's are plain XLA: a
DeepFM row of 17 params is no whole number of 16-byte vectors, which K1
and K2 move. `init_rows` writes the initializer's values and resets the
slots; `apply_gradients` optimizes each segment on the gathered arrays and
narrows the new params to a bf16 table stochastically with K3 on the
whole `[n, dim]` f32 block (when `spec.stochastic_rounding` and a seed are
given), to nearest otherwise. A serving replica holds the same kind of
state with no slots, `{"params": [cap, dim], "slots": []}`. `lookup`,
`assign_rows`, `params_np` and the other accessors take either layout.

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

TableState = Dict

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


def is_packed(spec: TableSpec) -> bool:
    """Whether a table can live in one packed pool (f32 or bf16)."""
    return spec.dtype in (torch.float32, torch.bfloat16)


def create_state(spec: TableSpec, device, packed: Optional[bool] = None
                 ) -> TableState:
    """Allocate one shard's state on `device`: by default (`packed` None)
    the packed pool for an f32 or bf16 table, the structure-of-arrays
    state otherwise. A packed pool is zeros in `spec.dtype`, with slot
    columns at their init value (rounded to nearest in a bf16 pool: 0.01
    is stored as 0.010009765625, as in the JAX package); the
    structure-of-arrays state has zero params in `spec.dtype` and f32
    slots at their init value."""
    cap = spec.capacity_per_shard
    if packed is None:
        packed = is_packed(spec)
    if not packed:
        return {"params": torch.zeros((cap, spec.dim), dtype=spec.dtype,
                                      device=device),
                "slots": [{name: torch.full((cap, k), init_value,
                                            dtype=torch.float32,
                                            device=device)
                           for name, (k, init_value)
                           in seg.optimizer.slot_spec(seg.dim).items()}
                          for seg in spec.segments]}
    _, padded, slots = _layout(spec)
    data = torch.zeros((cap, padded), dtype=spec.dtype, device=device)
    for (_, _name), (off, k, init_value) in slots.items():
        if init_value != 0.0:
            data[:, off:off + k] = init_value
    return {"data": data}


def map_state(fn, state: TableState) -> TableState:
    """`fn` applied to every tensor of a state of either layout (a host
    copy, a live prefix), in the state's own structure."""
    if "data" in state:
        return {"data": fn(state["data"])}
    return {"params": fn(state["params"]),
            "slots": [{name: fn(a) for name, a in seg.items()}
                      for seg in state["slots"]]}


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


def _read_rows(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """pool[rows] ([n, k], the pool's dtype); -1 and rows beyond the pool
    read zeros: `index_select` of the clamped rows, then a mask."""
    valid = _valid_rows(rows, pool.shape[0])
    out = pool.index_select(0, torch.where(valid, rows, 0).long())
    return torch.where(valid[:, None], out, 0)


def _write_rows(pool: torch.Tensor, rows: torch.Tensor,
                values: torch.Tensor) -> None:
    """pool[rows[i]] = values[i] in place for the rows inside the pool
    (unique among themselves); -1 and rows beyond the pool drop. One
    `index_copy_`, with nothing that waits for the device: each dropped
    entry writes the first kept entry's row and value again (or, when
    none is kept, row 0 its own content), so every write to a row carries
    the same bits and their order cannot matter."""
    valid = _valid_rows(rows, pool.shape[0])
    first = valid.to(torch.int32).argmax()
    keep_any = valid[first]
    first_row = torch.where(keep_any, rows[first], 0).long()
    first_val = torch.where(keep_any, values[first].to(pool.dtype), pool[0])
    idx = torch.where(valid, rows.long(), first_row)
    vals = torch.where(valid[:, None], values.to(pool.dtype), first_val)
    pool.index_copy_(0, idx, vals)


def _segment_slot_names(seg) -> List[str]:
    return sorted(seg.optimizer.slot_spec(seg.dim))


def lookup(spec: TableSpec, state: TableState,
           rows: torch.Tensor) -> torch.Tensor:
    """Gather rows ([n] int32; -1 and rows beyond the pool -> zeros) as
    [n, dim] f32. K1 on a packed state; `index_select` on clamped rows and
    a mask on a structure-of-arrays state."""
    if "data" in state:
        return params_of(spec, gather_packed(spec, state, rows))
    return _read_rows(state["params"], rows).float()


def init_rows(spec: TableSpec, state: TableState, rows: torch.Tensor,
              generator: torch.Generator) -> TableState:
    """Initialise newly admitted (or recycled) rows of a
    structure-of-arrays state in place: the initializer's values for the
    params (drawn from `generator`, narrowed to the table's dtype to
    nearest) and every optimizer slot RESET to its init value, so that a
    recycled row inherits no accumulator state. -1 rows drop. (A packed
    pool's new rows are a select in the engine's fused_lookup.)"""
    n = rows.shape[0]
    device = rows.device
    values = torch.cat([seg.initializer.init(generator, (n, seg.dim), device)
                        for seg in spec.segments], dim=-1)
    _write_rows(state["params"], rows, values.to(spec.dtype))
    for seg, seg_slots in zip(spec.segments, state["slots"]):
        slot_spec = seg.optimizer.slot_spec(seg.dim)
        for name, arr in seg_slots.items():
            k, init_value = slot_spec[name]
            _write_rows(arr, rows, torch.full((n, k), init_value,
                                              dtype=arr.dtype, device=device))
    return state


def apply_gradients(spec: TableSpec, state: TableState, rows: torch.Tensor,
                    grads: torch.Tensor, step: int,
                    seed: Optional[int] = None) -> TableState:
    """Per-segment per-row optimize of `rows` ([m] unique; -1 drop) with
    `grads` [m, dim] on a structure-of-arrays state, in place: gather the
    params (as f32) and every slot, apply each segment's optimizer, write
    the slots back and the params narrowed to the table's dtype: a bf16
    table with stochastic rounding and a `seed` through K3 on the
    concatenated [m, dim] f32 params, any other with a plain cast. (A
    packed pool's is the engine's fused_apply.)"""
    p = _read_rows(state["params"], rows).float()
    new_p = []
    off = 0
    for seg, seg_slots in zip(spec.segments, state["slots"]):
        gathered = {name: _read_rows(arr, rows)
                    for name, arr in seg_slots.items()}
        p_seg, slots_new = seg.optimizer.apply(
            p[:, off:off + seg.dim], gathered,
            grads[:, off:off + seg.dim], seg.learning_rate(step), step)
        new_p.append(p_seg)
        for name, val in slots_new.items():
            _write_rows(seg_slots[name], rows, val)
        off += seg.dim
    new_p = torch.cat(new_p, dim=-1)
    params = state["params"]
    if (spec.stochastic_rounding and seed is not None
            and params.dtype == torch.bfloat16):
        new_p = stochastic_round_bf16(new_p.contiguous(), seed)
    _write_rows(params, rows, new_p.to(params.dtype))
    return state


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
    _write_rows(state["params"], rows, values)
    return state


def restore_packed_rows(spec: TableSpec, state: TableState,
                        rows: torch.Tensor, values: torch.Tensor
                        ) -> TableState:
    """Write the full state of `rows` of a structure-of-arrays state in
    place from [n, width] f32 values in the packed column order (params,
    then each segment's slots in sorted-name order; tiered.pack_rows'
    format): the revive of archived rows. -1 rows drop. Params narrow to
    the table's dtype to nearest. (A packed pool's revive is laid over the
    gathered rows in the engine's fused_lookup.)"""
    _write_rows(state["params"], rows, values[:, :spec.dim])
    off = spec.dim
    for seg, seg_slots in zip(spec.segments, state["slots"]):
        for name in sorted(seg_slots):
            k = seg_slots[name].shape[1]
            _write_rows(seg_slots[name], rows, values[:, off:off + k])
            off += k
    return state


def full_rows(spec: TableSpec, state: TableState,
              rows: torch.Tensor) -> torch.Tensor:
    """[n, width] f32 full state of `rows` (-1 -> zeros) in the packed
    column order, on the state's device: the inverse of
    restore_packed_rows, what a spill archives. One K1 on a packed state;
    one `index_select` an array otherwise."""
    if "data" in state:
        return gather_packed(spec, state, rows)[:, :_layout(spec)[0]]
    pieces = [_read_rows(state["params"], rows).float()]
    for seg_slots in state["slots"]:
        pieces += [_read_rows(seg_slots[name], rows).float()
                   for name in sorted(seg_slots)]
    return torch.cat(pieces, dim=-1)


def zero_rows(state: TableState, rows: torch.Tensor) -> TableState:
    """Zero `rows` (-1 drop) in place in every array of a
    structure-of-arrays state, params and slots alike, as the JAX
    package's zero_rows sets them all to 0. (A packed pool's is the
    engine's K2 of zero rows.)"""
    map_state(lambda a: _write_rows(
        a, rows, a.new_zeros((rows.shape[0], a.shape[1]))), state)
    return state


def params_view(spec: TableSpec, state: TableState) -> torch.Tensor:
    """[cap, dim] params of a state in either layout (a view)."""
    if "data" in state:
        return state["data"][:, :spec.dim]
    return state["params"]


def slot_view(spec: TableSpec, state: TableState, seg_idx: int,
              name: str) -> torch.Tensor:
    """[cap, k] optimizer slot of a state in either layout (a view)."""
    if "data" in state:
        off, k, _ = _layout(spec)[2][(seg_idx, name)]
        return state["data"][:, off:off + k]
    return state["slots"][seg_idx][name]


def params_np(spec: TableSpec, state: TableState) -> np.ndarray:
    """[n, dim] params of a table state (either kind), f32 on the host."""
    return params_view(spec, state).cpu().float().numpy()


def slot_items_np(spec: TableSpec, state: TableState
                  ) -> List[Tuple[str, np.ndarray]]:
    """[('seg{i}/{name}', [n, k]), ...] of a state of either layout, f32 on
    the host, in (segment, sorted name) order."""
    if "data" in state:
        data = state["data"].cpu().float().numpy()
        slot_offs = _layout(spec)[2]
        out = []
        for i, seg in enumerate(spec.segments):
            for name in _segment_slot_names(seg):
                off, k, _ = slot_offs[(i, name)]
                out.append((f"seg{i}/{name}", data[:, off:off + k]))
        return out
    return [(f"seg{i}/{name}", arr.cpu().float().numpy())
            for i, seg_slots in enumerate(state["slots"])
            for name, arr in sorted(seg_slots.items())]


def slot_arrays(spec: TableSpec, state: TableState
                ) -> List[Tuple[str, np.ndarray]]:
    """The JAX package's name for slot_items_np."""
    return slot_items_np(spec, state)


def state_from_np(spec: TableSpec, pool: np.ndarray,
                  slots: Dict[str, np.ndarray], device,
                  packed: Optional[bool] = None) -> TableState:
    """Build a device state of either layout (`packed` as create_state's)
    from host arrays: pool [h, dim], slots {'seg{i}/{name}': [h, k]} with
    h <= capacity (a checkpoint's live prefix). Rows from h up are what
    `create_state` gives a fresh state (params zero, slots at their init
    value) and are made on the device, so only the h rows cross; a slot
    missing from `slots` starts at its init value. Params narrow to a bf16
    table with a plain cast, exact for values that came from one."""
    h = pool.shape[0]
    if h > spec.capacity_per_shard:
        raise ValueError(f"table {spec.name}: {h} rows do not fit "
                         f"capacity_per_shard {spec.capacity_per_shard}")
    state = create_state(spec, device, packed=packed)
    if "data" not in state:
        state["params"][:h] = torch.from_numpy(
            np.array(pool, np.float32)).to(device).to(spec.dtype)
        for i, seg_slots in enumerate(state["slots"]):
            for name, arr in seg_slots.items():
                if f"seg{i}/{name}" in slots:
                    arr[:h] = torch.from_numpy(np.array(
                        slots[f"seg{i}/{name}"], np.float32)).to(device)
        return state
    _, padded, slot_offs = _layout(spec)
    prefix = np.zeros((h, padded), np.float32)
    prefix[:, :spec.dim] = pool
    for (i, name), (off, k, init_value) in slot_offs.items():
        prefix[:, off:off + k] = slots.get(f"seg{i}/{name}", init_value)
    state["data"][:h] = torch.from_numpy(prefix).to(device).to(spec.dtype)
    return state

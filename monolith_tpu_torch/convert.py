"""Carry a trainer's state across, as numpy arrays.

The state format is the JAX trainer's, in numpy:

    {"params":         flax params tree, e.g. {"deep": {"dense_0":
                       {"kernel": [in, out], "bias": [out]}, ...}}
                       (DeepFM's tower; MovieRanking's is "ratings"),
     "opt_state":      the dense optimizer's state as flax writes it
                       (`to_state_dict`; e.g. optax.adagrad's
                       {"0": {"sum_of_squares": <params tree>}, "1": {}}),
     "model_state":    the non-parameter collections, {"batch_stats":
                       {...: {"mean", "var"}}} or {} for a model without,
     "tables":         {table: packed pools [S, cap, P] (or [cap, P] for
                       one shard), f32 whatever the pool's dtype; or,
                       for a structure-of-arrays state, the JAX
                       package's {"params": [S, cap, dim], "slots":
                       [{name: [S, cap, k]} for each segment]}, f32},
     "stores":         {table: HostStore.save() -> (fids, rows, tss, counts)}
                       for one shard; {table: [save of shard s, ...]} for
                       S > 1,
     "step":           int}

A sharded state carries all S shards' pools and host stores: a
`ShardedTrainer` on rank r loads pool r and every host store (each rank
holds all S), and exports its own pool as [1, cap, P] beside all S stores;
a `MultiHostTrainer` on rank r loads pool r and store r alone, and exports
its pool beside a list of S stores that is None but at r. A JAX
`MultiHostTrainer` run in one process reads out as a `ShardedTrainer`
does, with all S.

`load_state` writes such a state into a port `Trainer` (Dense kernels are
transposed into `nn.Linear`'s [out, in]; every other leaf crosses by name
as it is; the optimizer's tree goes through the optimizer's own
`load_state_tree`); `export_state` reads a port trainer back out in the
same form, so a state also moves between two port trainers (the card and
the CPU). An `Estimator`'s state is its `trainer`'s. `jax_trainer_state`
reads the JAX package's trainer into the format with numpy alone, and
`port_trainer_config` reads its `TrainerConfig` into the port's with the
same settings (clip_norm, steps_per_dispatch, per-table caps,
async_optimize, record_touch, tiered, ...). `jax_archives` and
`load_archives` carry a tiered trainer's host archives across, so that the
two packages can start a tiered run from identical state: a JAX sharded
trainer's archive of shard r goes to rank r of a port `ShardedTrainer` or
`MultiHostTrainer`, which holds that archive alone.

Row optimizer slots travel inside the packed pool, at the offsets that
`table._layout` gives them in both packages, so no row optimizer needs
code here. `load_state` writes a table in either layout into a trainer of
either (`EngineConfig.packed`): the params and each slot go to their
columns or arrays, so a packed state loads into a structure-of-arrays
trainer and back.

A bf16 pool travels as f32: widening it is exact, and `load_state` narrows
it back exactly (it raises on a value that bf16 cannot hold, rather than
round it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from monolith_tpu_torch.embedding import table as table_lib


def port_trainer_config(jax_config):
    """The port's TrainerConfig with the settings of a JAX-package
    TrainerConfig (read by attribute; nothing of JAX is imported)."""
    from monolith_tpu_torch.embedding.engine import EngineConfig
    from monolith_tpu_torch.training.trainer import TrainerConfig
    je = jax_config.engine
    return TrainerConfig(
        engine=EngineConfig(
            num_shards=je.num_shards, unique_cap=je.unique_cap,
            new_cap=je.new_cap, unique_caps=je.unique_caps,
            new_caps=je.new_caps, async_optimize=je.async_optimize,
            record_touch=je.record_touch, tiered=je.tiered,
            archive_capacity=je.archive_capacity, exchange=je.exchange,
            bucket_cap=je.bucket_cap, local_shards=je.local_shards,
            compact_wire=je.compact_wire, packed=je.packed),
        clip_norm=jax_config.clip_norm, seed=jax_config.seed,
        log_every=jax_config.log_every,
        metrics_enabled=jax_config.metrics_enabled,
        steps_per_dispatch=jax_config.steps_per_dispatch)


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax leaf path -> (nn.Module parameter name, transpose?). A Dense
    `kernel` is `nn.Linear`'s `weight`, transposed; every other leaf
    (`bias`, `allint_kernel`, `cin_w_0`, `pos_emb`, BatchNorm's `mean`,
    ...) keeps its name and its layout. A flax leaf named `weight` would
    read back as a kernel, so it has no counterpart."""
    leaf = path[-1]
    if leaf == "kernel":
        return ".".join(path[:-1] + ("weight",)), True
    if leaf == "weight":
        raise ValueError(f"no port counterpart for flax parameter "
                         f"{'/'.join(path)}")
    return ".".join(path), False


def _to_module_tensors(tree, transpose: bool = True
                       ) -> Dict[str, np.ndarray]:
    out = {}
    for path, arr in _flatten(tree).items():
        name, is_kernel = _torch_name(path)
        out[name] = arr.T if is_kernel and transpose else arr
    return out


def _to_flax_tree(named: Dict[str, np.ndarray], transpose: bool = True
                  ) -> Dict:
    tree: Dict = {}
    for name, arr in named.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = arr.T if transpose else arr
        else:
            node[leaf] = arr
    return tree


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """Never a view of the live (possibly CPU) tensor."""
    return t.detach().cpu().numpy().copy()


def dense_tree(named, transpose: bool = True) -> Dict:
    """The flax-form tree (numpy, kernels [in, out]) of named tensors: a
    module's `named_parameters()` or `named_buffers()`, or an optimizer's
    accumulators. `transpose=False` renames a `weight` to `kernel` without
    transposing it: for tensors already held in flax's orientation
    (Shampoo's state)."""
    return _to_flax_tree({n: _host_copy(t) for n, t in dict(named).items()},
                         transpose)


@torch.no_grad()
def load_dense_tree(dst: Dict[str, torch.Tensor], tree: Dict,
                    transpose: bool = True) -> None:
    """Write a flax-form tree into named tensors in place; the names and
    shapes must match exactly."""
    named = _to_module_tensors(tree, transpose)
    if set(named) != set(dst):
        raise ValueError(f"parameter names differ: {sorted(named)} vs "
                         f"{sorted(dst)}")
    for name, arr in named.items():
        if tuple(arr.shape) != tuple(dst[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(dst[name].shape)}")
        dst[name].copy_(torch.from_numpy(np.array(arr)))


def model_state_tree(module) -> Dict:
    """A module's non-parameter state as flax's collections: its buffers
    (BatchNorm's `mean` / `var`) as {"batch_stats": tree}, or {} for a
    module without."""
    buffers = dict(module.named_buffers())
    return {"batch_stats": dense_tree(buffers)} if buffers else {}


def load_model_state(module, tree: Dict) -> None:
    """Write a `model_state_tree` into the module's buffers in place; the
    collections, names and shapes must match exactly."""
    want = model_state_tree(module)
    if set(tree) != set(want):
        raise ValueError(f"model state collections differ: {sorted(tree)} "
                         f"vs {sorted(want)}")
    if tree:
        load_dense_tree(dict(module.named_buffers()), tree["batch_stats"])


@torch.no_grad()
def load_state(trainer, state: Dict) -> None:
    """Write a numpy state (format above) into a port Trainer, in place."""
    load_dense_tree(dict(trainer.module.named_parameters()), state["params"])
    trainer.tx.load_state_tree(trainer.opt_state, state["opt_state"])
    load_model_state(trainer.module, state["model_state"])
    S = trainer.engine.config.num_shards
    for tname, value in state["tables"].items():
        spec = trainer.engine.tables[tname]
        params, slots = _table_arrays(spec, value)
        if S > 1 and params.ndim == 3 and params.shape[0] == S:
            # every shard's: take ours
            params = params[trainer.engine.shard]
            slots = {k: v[trainer.engine.shard] for k, v in slots.items()}
        params = params.reshape(params.shape[-2:])
        slots = {k: v.reshape(v.shape[-2:]) for k, v in slots.items()}
        dst = trainer.table_states[tname]
        if "data" in dst:
            data = np.zeros(tuple(dst["data"].shape), np.float32)
            data[:, :spec.dim] = params
            for (i, name), (off, k, _) in table_lib._layout(spec)[2].items():
                data[:, off:off + k] = slots[f"seg{i}/{name}"]
            _copy_exact(dst["data"], data, tname)
            continue
        _copy_exact(dst["params"], params, tname)
        for i, seg_slots in enumerate(dst["slots"]):
            for name, arr in seg_slots.items():
                _copy_exact(arr, slots[f"seg{i}/{name}"], tname)
    for tname, saved in state["stores"].items():
        shards = trainer.engine.shard_stores[tname]
        for store, one in zip(shards, saved if S > 1 else [saved]):
            if store is not None:   # a shard this process holds
                store.restore(*one)
    trainer.step = int(state["step"])


def _table_arrays(spec, value) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(params [..., cap, dim], {'seg{i}/{name}': [..., cap, k]}) f32 of a
    table in the format above, packed or structure of arrays."""
    if isinstance(value, dict):
        return (np.asarray(value["params"], np.float32),
                {f"seg{i}/{name}": np.asarray(a, np.float32)
                 for i, seg in enumerate(value["slots"])
                 for name, a in seg.items()})
    data = np.asarray(value, np.float32)
    return (data[..., :spec.dim],
            {f"seg{i}/{name}": data[..., off:off + k]
             for (i, name), (off, k, _) in table_lib._layout(spec)[2].items()})


def _copy_exact(dst: torch.Tensor, src: np.ndarray, tname: str) -> None:
    """dst <- src (f32), narrowed to dst's dtype; raises where the
    narrowing is not exact."""
    src = torch.from_numpy(np.array(src, dtype=np.float32).reshape(dst.shape))
    if dst.dtype != torch.float32:
        narrowed = src.to(dst.dtype)
        if not torch.equal(narrowed.float(), src):
            raise ValueError(f"table {tname}: the state holds values that a "
                             f"{dst.dtype} array cannot hold")
        src = narrowed
    dst.copy_(src)


def _table_value(state) -> object:
    """One table's state in the format above, one shard [1, ...]: the
    packed pool, or the structure-of-arrays dict."""
    if "data" in state:
        return _host_copy(state["data"].float())[None]
    return {"params": _host_copy(state["params"].float())[None],
            "slots": [{name: _host_copy(a.float())[None]
                       for name, a in seg.items()} for seg in state["slots"]]}


def export_state(trainer) -> Dict:
    """Read a port Trainer's state out in the numpy format above."""
    return {"params": dense_tree(trainer.module.named_parameters()),
            "opt_state": trainer.tx.state_tree(trainer.opt_state),
            "model_state": model_state_tree(trainer.module),
            "tables": {t: _table_value(st)
                       for t, st in trainer.table_states.items()},
            "stores": _saved_stores(trainer.engine.shard_stores),
            "step": trainer.step}


def _saved_stores(shard_stores) -> Dict:
    """{table: save()} of one shard's stores, {table: [save(), ...]} of
    S > 1 shards' (None for a shard whose store is not held)."""
    return {t: shards[0].save() if len(shards) == 1
            else [None if s is None else s.save() for s in shards]
            for t, shards in shard_stores.items()}


def jax_trainer_state(jax_trainer) -> Dict:
    """The JAX package's Trainer state in the numpy format (np.asarray on
    its arrays; nothing of JAX is imported here): a ShardedTrainer's with
    all S shards' pools and stores. A bf16 pool reads as f32."""
    return {"params": _state_dict(jax_trainer.params),
            "opt_state": _state_dict(jax_trainer.opt_state),
            "model_state": _state_dict(jax_trainer.model_state),
            "tables": {t: _jax_table(st)
                       for t, st in jax_trainer.table_states.items()},
            "stores": _saved_stores(jax_trainer.engine.stores),
            "step": int(jax_trainer.step)}


def _jax_table(st):
    """A JAX table state [S, ...] in the format above, f32."""
    if "data" in st:
        return np.asarray(st["data"]).astype(np.float32)
    return {"params": np.asarray(st["params"]).astype(np.float32),
            "slots": [{name: np.asarray(a).astype(np.float32)
                       for name, a in seg.items()} for seg in st["slots"]]}


def _state_dict(x):
    """flax's `serialization.to_state_dict` of a JAX tree, in numpy: a
    dict by its keys, a NamedTuple (optax's states) by its fields, a tuple
    or list by position ("0", "1", ...), an array as numpy."""
    if hasattr(x, "items"):
        return {str(k): _state_dict(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _state_dict(getattr(x, f)) for f in x._fields}
    if isinstance(x, (tuple, list)):
        return {str(i): _state_dict(v) for i, v in enumerate(x)}
    return np.asarray(x)


def jax_archives(jax_trainer, shard: int = 0) -> Dict:
    """A tiered JAX trainer's host archives of one shard (0: a
    single-device trainer's one; r: what rank r of a port sharded or
    multi-host run holds) in numpy: {table: {"fids", "rows", "map_tss", "tss", "values",
    "spilled", "revived", "dropped"}}: the archive map's entries (with the
    map's timestamps, which order recycling), and each entry's spill
    timestamp and archived row."""
    return {t: _archive_state(shards[shard])
            for t, shards in jax_trainer.engine.archives.items()}


def export_archives(trainer) -> Dict:
    """A tiered port trainer's host archives of its own shard, in
    jax_archives' format."""
    return {t: _archive_state(trainer.engine.archive_of(t))
            for t in trainer.engine.shard_archives}


def _archive_state(archive) -> Dict:
    fids, rows, map_tss, _ = archive.map.save()
    return {"fids": fids, "rows": rows, "map_tss": map_tss,
            "tss": archive.tss[rows].copy(),
            "values": archive.values[rows].copy(),
            "spilled": archive.spilled, "revived": archive.revived,
            "dropped": archive.dropped}


def load_archives(archives, state: Dict) -> None:
    """Write archives in jax_archives' format into RowArchive objects
    {table: archive} of either package (a port trainer's own, `{t:
    engine.archive_of(t)}`, or a JAX trainer's of one shard), in place:
    the same entries at the same archive rows, values, timestamps and
    counters."""
    for tname, st in state.items():
        arch = archives[tname]
        arch.map.restore(st["fids"], st["rows"], st["map_tss"], None)
        arch.values[:] = 0
        arch.values[st["rows"]] = st["values"]
        arch.tss[:] = 0
        arch.tss[st["rows"]] = st["tss"]
        arch.spilled, arch.revived, arch.dropped = (
            st["spilled"], st["revived"], st["dropped"])

"""Checkpoint save/restore for trainer state, in the JAX package's on-disk
layout: a checkpoint written by either package restores in the other.

Layout (one directory per step):
    <dir>/ckpt-<step>/
        meta.json                      step, ts, table inventory
        dense.msgpack                  dense params (flax tree, msgpack)
        opt_state.msgpack              dense optimizer state
        model_state.msgpack            non-parameter state (BatchNorm's
                                       batch_stats), for a model with any
        tables/<table>-s<k>.npz        shard k's pool params + optimizer
                                       slot arrays + host map dump
                                       (fids/rows/tss/counts)
        filters/<table>-s<k>.bin       shard k's admission-filter state
        archives/<table>-s<k>.npz      a tiered table's host archive of
                                       shard k (fids, rows, tss, values)
    <dir>/CHECKPOINT                   latest step pointer

`tables/*.npz` holds the live prefix of the pool only (`pool[:high-water]`:
rows come from a dense free list, so every live row lies below the highest
row in use), params and slots as separate f32 arrays. The prefix is sliced
on the device and only that is copied to the host; restore uploads only the
prefix and makes the rows above it on the device (`table.state_from_np`),
so neither direction moves or holds a full-capacity pool on the host.
The files are the same for a packed pool and a structure-of-arrays state
(`EngineConfig(packed="off")`), so a checkpoint restores into either
layout, as the JAX package's restore rebuilds whichever layout the
trainer holds.

A trainer of S > 1 shards (one process a rank: `parallel.MultiHostTrainer`,
`parallel.ShardedTrainer`) saves from every rank (`save`, or its JAX name
`save_distributed`): rank r writes its own shard's `-s<r>` table, filter
and archive files, rank 0 the dense, optimizer and model state and
`meta.json` with `"shards": S`, and a barrier on the trainer's gloo group
comes before the `CHECKPOINT` pointer and another after it, so no rank
sees a checkpoint half written. `restore` (`restore_distributed`) reads
any shard count into any: at the same count
each held host store reads its own shard's file (a `ShardedTrainer` rank
holds all S) and the rank's pool its own; at another count every rank
reads every old shard and keeps the entries that `shard_of_batch(fid, S)`
routes to its shards, packed into rows 0..n-1 (1 -> N, N -> M, and the
fold N -> 1 into a single-device Trainer). Filters are not carried across
counts, as in the JAX package. Archives are read by shard index: a cold
row whose id moves to another shard at a new count starts afresh when the
id comes back.

`opt_state.msgpack` is the tree flax writes for the dense optimizer's
optax state (the optimizer's `state_tree`: optax.adagrad's is
`{"0": {"sum_of_squares": <params tree>}, "1": {}}`); `model_state.msgpack`
is `Trainer.model_state`, `{"batch_stats": ...}`. Restore reads
`model_state.msgpack` into a model that has such state, as the JAX package
does (a model without ignores the file).

Deltas (`save_delta` / `restore_delta`) carry only the rows touched since
a timestamp, as (fids, tss, counts, values), one `<table>-s<k>.npz` a
shard as the JAX package writes them; `restore_delta` assigns rows through
the host map and writes the values with `table.assign_rows`, which on the
card is K1, an overwrite of the params columns, and K2. Every rank of a
`ShardedTrainer` calls both: rank r writes shard r's files from its own
pool, rank 0 `meta.json` after a barrier; on restore every rank assigns
each shard file's ids into its copy of that shard's store (the stores stay
identical) and writes only its own shard's rows into its pool. A delta of
another shard count is refused, and so is a `MultiHostTrainer` (its ranks
hold one store each; the JAX package's `save_delta` cannot run on such a
trainer either).

`save(..., evict_before_save=True)` first runs expiry on every table with
a ttl (`trainer.evict_expired(now - ttl)`), as the JAX package does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from monolith_tpu_torch import convert, serialization
from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.embedding.host_store import shard_of_batch


def _tables_dir(path):
    return os.path.join(path, "tables")


def _rows_tensor(rows: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(device)


def save(trainer, directory: str, evict_before_save: bool = False,
         dense_only: bool = False) -> str:
    """Save trainer state; returns the checkpoint path. Every rank of a
    sharded run calls it: rank r writes shard r's files, rank 0 the dense
    state and the metadata, and the ranks meet before the `CHECKPOINT`
    pointer and after it."""
    step = trainer.step
    shards, own = trainer.engine.config.num_shards, trainer.engine.shard
    path = os.path.join(directory, f"ckpt-{step}")
    os.makedirs(_tables_dir(path), exist_ok=True)
    os.makedirs(os.path.join(path, "filters"), exist_ok=True)

    if evict_before_save:
        now = int(time.time())
        for spec in trainer.engine.tables.values():
            if spec.eviction.ttl_seconds > 0:
                trainer.evict_expired(now - spec.eviction.ttl_seconds)

    if own == 0:
        with open(os.path.join(path, "dense.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(
                convert.dense_tree(trainer.module.named_parameters())))
        with open(os.path.join(path, "opt_state.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(
                trainer.tx.state_tree(trainer.opt_state)))
        serialization.save_model_state(path, trainer.model_state)

    meta = {"step": step, "ts": int(time.time()), "dense_only": dense_only,
            "tables": {}}
    if not dense_only:
        for tname, spec in trainer.engine.tables.items():
            meta["tables"][tname] = {"shards": shards, "dim": spec.dim}
            _save_table(trainer, tname, spec, path, own)

    _save_archives(trainer, path)
    trainer._barrier()
    if own == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(directory, "CHECKPOINT"), "w") as f:
            f.write(str(step))
    trainer._barrier()
    return path


def save_distributed(trainer, directory: str,
                     evict_before_save: bool = False,
                     dense_only: bool = False) -> str:
    """The JAX package's save of a multi-process trainer: `save`, which
    writes per shard at any shard count."""
    return save(trainer, directory, evict_before_save, dense_only)


def _save_table(trainer, tname, spec, path, shard: int) -> None:
    """`tables/<table>-s<shard>.npz` (and its filter) of the trainer's own
    shard: the store's dump and the live prefix of its pool."""
    store = trainer.engine.store_of(tname)
    fids, rows, tss, counts = store.save()
    hw = int(rows.max()) + 1 if len(rows) else 0
    # the live prefix: sliced on the device, only it comes back
    live = table_lib.map_state(lambda a: a[:hw].cpu(),
                               trainer.table_states[tname])
    arrays = {"pool": table_lib.params_np(spec, live),
              "fids": fids, "rows": rows, "tss": tss, "counts": counts}
    for name, arr in table_lib.slot_items_np(spec, live):
        arrays["slot:" + name] = arr
    np.savez(os.path.join(_tables_dir(path), f"{tname}-s{shard}.npz"),
             **arrays)
    blob = store.filter_save()
    if blob:
        with open(os.path.join(path, "filters", f"{tname}-s{shard}.bin"),
                  "wb") as f:
            f.write(blob)


def _save_archives(trainer, path) -> None:
    """A tiered trainer's host archive of its own shard, so that a restart
    keeps its cold rows: `archives/<table>-s<k>.npz` for a non-empty
    archive."""
    if not trainer.engine.config.tiered:
        return
    adir = os.path.join(path, "archives")
    os.makedirs(adir, exist_ok=True)
    own = trainer.engine.shard
    for tname in trainer.engine.tables:
        arch = trainer.engine.archive_of(tname)
        if arch.size() > 0:
            arch.save(os.path.join(adir, f"{tname}-s{own}.npz"))


def _restore_archives(trainer, path) -> None:
    """Read back `archives/<table>-s<k>.npz` of the trainer's own shard k
    into its archives, whatever the checkpoint's shard count (archives go
    by shard index, as in the JAX package)."""
    adir = os.path.join(path, "archives")
    if not trainer.engine.config.tiered or not os.path.isdir(adir):
        return
    own = trainer.engine.shard
    for tname in trainer.engine.tables:
        p = os.path.join(adir, f"{tname}-s{own}.npz")
        if os.path.exists(p):
            trainer.engine.archive_of(tname).restore(p)


def _delta_capable(trainer) -> None:
    """Refuse a trainer whose ranks do not hold every shard's store."""
    if trainer.engine.config.local_shards is not None:
        raise ValueError(
            "deltas of a multi-host trainer are not supported: its ranks "
            "hold one shard's host store each, and the JAX package's "
            "save_delta fails on such a trainer too; save a checkpoint "
            "(save / save_distributed) instead")


def save_delta(trainer, directory: str, since_ts: int,
               base_step: Optional[int] = None) -> str:
    """Incremental checkpoint: save only rows whose last update ts >=
    since_ts. Layout: <dir>/delta-<step>/<table>-s<k>.npz with (fids, tss,
    counts, values) a shard k, and meta.json; row indices are NOT saved,
    restore_delta re-assigns rows through the host map. Only the delta
    rows are gathered on the device (K1 on the card) and copied back, never
    the pool. Every rank of a sharded trainer calls it: rank r writes shard
    r's file, rank 0 `meta.json` once every file is written."""
    _delta_capable(trainer)
    step, engine = trainer.step, trainer.engine
    own = engine.shard
    path = os.path.join(directory, f"delta-{step}")
    os.makedirs(path, exist_ok=True)
    meta = {"step": step, "since_ts": int(since_ts), "base_step": base_step,
            "ts": int(time.time()), "tables": {}}
    for tname, spec in engine.tables.items():
        meta["tables"][tname] = {"shards": engine.config.num_shards,
                                 "dim": spec.dim}
        fids, rows, tss, counts = engine.store_of(tname).save()
        sel = tss >= np.uint32(since_ts)
        fids, rows, tss, counts = fids[sel], rows[sel], tss[sel], counts[sel]
        if len(rows):
            values = table_lib.lookup(
                spec, trainer.table_states[tname],
                _rows_tensor(rows, trainer.device)).cpu().numpy()
        else:
            values = np.zeros((0, spec.dim), np.float32)
        np.savez(os.path.join(path, f"{tname}-s{own}.npz"),
                 fids=fids, tss=tss, counts=counts, values=values)
    trainer._barrier()
    if own == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    trainer._barrier()
    return path


@torch.no_grad()
def restore_delta(trainer, delta_path: str) -> int:
    """Apply an incremental checkpoint on top of current state: new ids are
    admitted through the host map, existing ids overwritten. Optimizer slot
    state is NOT in deltas (full checkpoints carry it); rows newly admitted
    here keep freshly-initialized slots. Ids the store refuses (out of
    capacity) map to row -1 and drop. Shard k's file goes into shard k's
    store on every rank and into rank k's pool. Returns the number of rows
    applied over every shard. A delta of another shard count than the
    trainer's raises ValueError (the JAX package would put shard k's ids
    into store k whatever the count)."""
    _delta_capable(trainer)
    engine = trainer.engine
    with open(os.path.join(delta_path, "meta.json")) as f:
        meta = json.load(f)
    S = engine.config.num_shards
    for tname, tmeta in meta["tables"].items():
        if tmeta["shards"] != S:
            raise ValueError(
                f"delta {delta_path}: table '{tname}' has {tmeta['shards']} "
                f"shards and the trainer {S}; a delta restores into a "
                f"trainer of its own shard count (restore a full checkpoint "
                f"to change it)")
    applied = 0
    for tname, tmeta in meta["tables"].items():
        spec = engine.tables[tname]
        for s, store in enumerate(engine.shard_stores[tname]):
            z = np.load(os.path.join(delta_path, f"{tname}-s{s}.npz"))
            fids = z["fids"]
            if len(fids) == 0:
                continue
            rows, _, _ = store.assign(fids, ts=int(meta["ts"]))
            if s == engine.shard:
                values = torch.from_numpy(
                    np.ascontiguousarray(z["values"], np.float32))
                table_lib.assign_rows(spec, trainer.table_states[tname],
                                      _rows_tensor(rows, trainer.device),
                                      values.to(trainer.device))
            applied += int((rows >= 0).sum())
    trainer.step = meta["step"]
    return applied


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "CHECKPOINT")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


@torch.no_grad()
def restore(trainer, directory: str, step: Optional[int] = None) -> int:
    """Restore trainer state in place, from a checkpoint of any shard
    count into a trainer of any; returns the restored step. Every rank of
    a sharded run calls it. The module owns its parameters from
    construction, so (unlike the JAX trainer) no step has to run before a
    restore."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no CHECKPOINT in {directory}")
    path = os.path.join(directory, f"ckpt-{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    dense_path = os.path.join(path, "dense.msgpack")
    if os.path.exists(dense_path):
        params = dict(trainer.module.named_parameters())
        with open(dense_path, "rb") as f:
            convert.load_dense_tree(params, serialization.from_bytes(
                convert.dense_tree(params), f.read()))
        tx = trainer.tx
        with open(os.path.join(path, "opt_state.msgpack"), "rb") as f:
            tx.load_state_tree(trainer.opt_state, serialization.from_bytes(
                tx.state_tree(trainer.opt_state), f.read()))
        serialization.load_model_state(path, trainer.module)

    if not meta.get("dense_only"):
        for tname, tmeta in meta["tables"].items():
            _restore_table(trainer, tname, trainer.engine.tables[tname], path,
                           tmeta["shards"])

    _restore_archives(trainer, path)
    trainer.step = meta["step"]
    return meta["step"]


def restore_distributed(trainer, directory: str,
                        step: Optional[int] = None) -> int:
    """The JAX package's restore of a multi-process trainer: `restore`,
    which reads every topology."""
    return restore(trainer, directory, step)


def _restore_table(trainer, tname, spec, path, old_shards: int) -> None:
    """One table: every host store the trainer holds and its own shard's
    pool, from a checkpoint of `old_shards` shards."""
    engine = trainer.engine
    S, own = engine.config.num_shards, engine.shard
    cap = spec.capacity_per_shard
    stores = engine.shard_stores[tname]
    pool = slots = None
    if old_shards == S:
        for s, store in enumerate(stores):
            if store is None:
                continue
            z = np.load(os.path.join(_tables_dir(path), f"{tname}-s{s}.npz"))
            if z["pool"].shape[0] > cap:
                raise ValueError(
                    f"table '{tname}': the checkpoint's live prefix has "
                    f"{z['pool'].shape[0]} rows but capacity_per_shard is "
                    f"{cap}")
            store.restore(z["fids"], z["rows"], z["tss"], z["counts"])
            fpath = os.path.join(path, "filters", f"{tname}-s{s}.bin")
            if os.path.exists(fpath):
                with open(fpath, "rb") as f:
                    store.filter_restore(f.read())
            if s == own:
                pool = z["pool"]
                slots = {k[5:]: z[k] for k in z.files if k.startswith("slot:")}
    else:
        fids, tss, counts, values, slot_vals = _entries(path, tname, spec,
                                                        old_shards)
        dest = shard_of_batch(fids, S)
        for s, store in enumerate(stores):
            if store is None:
                continue
            sel = dest == s
            n = int(sel.sum())
            if n > cap:
                raise ValueError(
                    f"resharding table '{tname}' {old_shards}->{S}: shard "
                    f"{s} needs {n} rows but capacity_per_shard is {cap}")
            store.restore(fids[sel], np.arange(n, dtype=np.int32), tss[sel],
                          counts[sel])
            if s == own:
                pool = values[sel]
                slots = {k: v[sel] for k, v in slot_vals.items()}
    # the file holds pool[:high-water]; rows above it are made on the
    # device as a fresh pool has them (params zero, slots at their
    # optimizer's init value)
    trainer.table_states[tname] = table_lib.state_from_np(
        spec, pool, slots, trainer.device, packed=engine.packed)


def _entries(path, tname, spec, old_shards: int):
    """Every live entry of every old shard of a table, concatenated in
    shard order: (fids, tss, counts, params [n, dim], {slot: [n, k]})."""
    fids, tss, counts, values = [], [], [], []
    slot_vals: Dict[str, list] = {}
    for s in range(old_shards):
        z = np.load(os.path.join(_tables_dir(path), f"{tname}-s{s}.npz"))
        rows = z["rows"]
        fids.append(z["fids"])
        tss.append(z["tss"])
        counts.append(z["counts"])
        values.append(z["pool"][rows].reshape(len(rows), spec.dim))
        for k in z.files:
            if k.startswith("slot:"):
                slot_vals.setdefault(k[5:], []).append(z[k][rows])
    return (np.concatenate(fids), np.concatenate(tss),
            np.concatenate(counts), np.concatenate(values),
            {k: np.concatenate(v) for k, v in slot_vals.items()})

"""Checkpoint save/restore for trainer state, in the JAX package's on-disk
layout: a checkpoint written by either package restores in the other.

Layout (one directory per step):
    <dir>/ckpt-<step>/
        meta.json                      step, ts, table inventory
        dense.msgpack                  dense params (flax tree, msgpack)
        opt_state.msgpack              dense optimizer state
        model_state.msgpack            non-parameter state (BatchNorm's
                                       batch_stats), for a model with any
        tables/<table>-s0.npz          pool params + optimizer slot arrays +
                                       host map dump (fids/rows/tss/counts)
        filters/<table>-s0.bin         admission-filter state
        archives/<table>-s0.npz        a tiered table's host archive
                                       (fids, rows, tss, values)
    <dir>/CHECKPOINT                   latest step pointer

The port's tables are single-shard, so it writes `-s0` files and
`"shards": 1`; it reads a checkpoint of any shard count (`_restore_resharded`
folds a sharded JAX trainer's files into the one shard). `tables/*.npz`
holds the live prefix of the pool only (`pool[:high-water]`: rows come from
a dense free list, so every live row lies below the highest row in use),
params and slots as separate f32 arrays. The prefix is sliced on the device
and only that is copied to the host; restore uploads only the prefix and
makes the rows above it on the device (`table.state_from_np`), so neither
direction moves or holds a full-capacity pool on the host.

`opt_state.msgpack` is the tree flax writes for the dense optimizer's
optax state (the optimizer's `state_tree`: optax.adagrad's is
`{"0": {"sum_of_squares": <params tree>}, "1": {}}`); `model_state.msgpack`
is `Trainer.model_state`, `{"batch_stats": ...}`. Restore reads
`model_state.msgpack` into a model that has such state, as the JAX package
does (a model without ignores the file).

Deltas (`save_delta` / `restore_delta`) carry only the rows touched since a
timestamp, as (fids, tss, counts, values); `restore_delta` assigns rows
through the host map and writes the values with `table.assign_rows`, which
on the card is K1, an overwrite of the params columns, and K2.

`save(..., evict_before_save=True)` first runs expiry on every table with
a ttl (`trainer.evict_expired(now - ttl)`), as the JAX package does. A
tiered trainer's archives are written to `archives/` (a non-empty archive
only) and read back on restore; a JAX checkpoint of several shards gives
the port the archive of shard 0, as it would a one-shard JAX trainer.
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


def _tables_dir(path):
    return os.path.join(path, "tables")


def _rows_tensor(rows: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(device)


def save(trainer, directory: str, evict_before_save: bool = False,
         dense_only: bool = False) -> str:
    """Save trainer state; returns the checkpoint path."""
    step = trainer.step
    path = os.path.join(directory, f"ckpt-{step}")
    os.makedirs(_tables_dir(path), exist_ok=True)
    os.makedirs(os.path.join(path, "filters"), exist_ok=True)

    if evict_before_save:
        now = int(time.time())
        for spec in trainer.engine.tables.values():
            if spec.eviction.ttl_seconds > 0:
                trainer.evict_expired(now - spec.eviction.ttl_seconds)

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
            meta["tables"][tname] = {"shards": 1, "dim": spec.dim}
            store = trainer.engine.stores[tname]
            fids, rows, tss, counts = store.save()
            hw = int(rows.max()) + 1 if len(rows) else 0
            # the live prefix: sliced on the device, only it comes back
            live = {k: v[:hw].cpu()
                    for k, v in trainer.table_states[tname].items()}
            arrays = {"pool": table_lib.params_np(spec, live),
                      "fids": fids, "rows": rows, "tss": tss,
                      "counts": counts}
            for name, arr in table_lib.slot_items_np(spec, live):
                arrays["slot:" + name] = arr
            np.savez(os.path.join(_tables_dir(path), f"{tname}-s0.npz"),
                     **arrays)
            blob = store.filter_save()
            if blob:
                with open(os.path.join(path, "filters", f"{tname}-s0.bin"),
                          "wb") as f:
                    f.write(blob)

    _save_archives(trainer, path)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, "CHECKPOINT"), "w") as f:
        f.write(str(step))
    return path


def _save_archives(trainer, path) -> None:
    """A tiered trainer's host archives, so that a restart keeps its cold
    rows: `archives/<table>-s0.npz` for every non-empty archive."""
    archives = trainer.engine.archives
    if not archives:
        return
    adir = os.path.join(path, "archives")
    os.makedirs(adir, exist_ok=True)
    for tname, arch in archives.items():
        if arch.size() > 0:
            arch.save(os.path.join(adir, f"{tname}-s0.npz"))


def _restore_archives(trainer, path) -> None:
    """Read back `archives/<table>-s0.npz` into a tiered trainer's
    archives. The port is one shard, so a JAX checkpoint of several gives
    it the archive of shard 0 only, as it gives a one-shard JAX trainer:
    the other shards' cold rows start afresh when their ids come back."""
    adir = os.path.join(path, "archives")
    if not trainer.engine.archives or not os.path.isdir(adir):
        return
    for tname, arch in trainer.engine.archives.items():
        p = os.path.join(adir, f"{tname}-s0.npz")
        if os.path.exists(p):
            arch.restore(p)


def save_delta(trainer, directory: str, since_ts: int,
               base_step: Optional[int] = None) -> str:
    """Incremental checkpoint: save only rows whose last update ts >=
    since_ts. Layout: <dir>/delta-<step>/<table>-s0.npz with (fids, tss,
    counts, values); row indices are NOT saved, restore_delta re-assigns
    rows through the host map. Only the delta rows are gathered on the
    device (K1 on the card) and copied back, never the pool."""
    step = trainer.step
    path = os.path.join(directory, f"delta-{step}")
    os.makedirs(path, exist_ok=True)
    meta = {"step": step, "since_ts": int(since_ts), "base_step": base_step,
            "ts": int(time.time()), "tables": {}}
    for tname, spec in trainer.engine.tables.items():
        meta["tables"][tname] = {"shards": 1, "dim": spec.dim}
        fids, rows, tss, counts = trainer.engine.stores[tname].save()
        sel = tss >= np.uint32(since_ts)
        fids, rows, tss, counts = fids[sel], rows[sel], tss[sel], counts[sel]
        if len(rows):
            values = table_lib.lookup(
                spec, trainer.table_states[tname],
                _rows_tensor(rows, trainer.device)).cpu().numpy()
        else:
            values = np.zeros((0, spec.dim), np.float32)
        np.savez(os.path.join(path, f"{tname}-s0.npz"),
                 fids=fids, tss=tss, counts=counts, values=values)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


@torch.no_grad()
def restore_delta(trainer, delta_path: str) -> int:
    """Apply an incremental checkpoint on top of current state: new ids are
    admitted through the host map, existing ids overwritten. Optimizer slot
    state is NOT in deltas (full checkpoints carry it); rows newly admitted
    here keep freshly-initialized slots. Ids the store refuses (out of
    capacity) map to row -1 and drop. Returns the number of rows applied."""
    with open(os.path.join(delta_path, "meta.json")) as f:
        meta = json.load(f)
    applied = 0
    for tname, tmeta in meta["tables"].items():
        spec = trainer.engine.tables[tname]
        for s in range(tmeta["shards"]):
            z = np.load(os.path.join(delta_path, f"{tname}-s{s}.npz"))
            fids = z["fids"]
            if len(fids) == 0:
                continue
            rows, _, _ = trainer.engine.stores[tname].assign(
                fids, ts=int(meta["ts"]))
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
    """Restore trainer state in place; returns the restored step. The
    module owns its parameters from construction, so (unlike the JAX
    trainer) no step has to run before a restore."""
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
            spec = trainer.engine.tables[tname]
            if tmeta["shards"] != 1:
                _restore_resharded(trainer, tname, spec, path,
                                   tmeta["shards"])
                continue
            z = np.load(os.path.join(_tables_dir(path), f"{tname}-s0.npz"))
            if z["pool"].shape[0] > spec.capacity_per_shard:
                raise ValueError(
                    f"table '{tname}': the checkpoint's live prefix has "
                    f"{z['pool'].shape[0]} rows but capacity_per_shard is "
                    f"{spec.capacity_per_shard}")
            store = trainer.engine.stores[tname]
            store.restore(z["fids"], z["rows"], z["tss"], z["counts"])
            fpath = os.path.join(path, "filters", f"{tname}-s0.bin")
            if os.path.exists(fpath):
                with open(fpath, "rb") as f:
                    store.filter_restore(f.read())
            # the file holds pool[:high-water]; rows above it are made on
            # the device as a fresh pool has them (params zero, slots at
            # their optimizer's init value)
            trainer.table_states[tname] = table_lib.state_from_np(
                spec, z["pool"],
                {k[5:]: z[k] for k in z.files if k.startswith("slot:")},
                trainer.device)

    _restore_archives(trainer, path)
    trainer.step = meta["step"]
    return meta["step"]


def _restore_resharded(trainer, tname, spec, path, old_shards: int) -> None:
    """Restore a table whose checkpoint has another shard count than the
    port's one (a sharded JAX trainer's): every entry (fid, ts, count,
    params, optimizer slots) of every old shard is concatenated and packed
    into contiguous rows 0..n-1 of the single shard. Admission filters are
    NOT carried over (count-min state is keyed to the old shard layout);
    live ids are already admitted via the restored map, so only the
    occurrence window of not-yet-admitted ids resets."""
    all_fids, all_tss, all_counts, pool_vals = [], [], [], []
    slot_vals: Dict[str, list] = {}
    for s in range(old_shards):
        z = np.load(os.path.join(_tables_dir(path), f"{tname}-s{s}.npz"))
        rows = z["rows"]
        all_fids.append(z["fids"])
        all_tss.append(z["tss"])
        all_counts.append(z["counts"])
        pool_vals.append(z["pool"][rows])
        for k in z.files:
            if k.startswith("slot:"):
                slot_vals.setdefault(k[5:], []).append(z[k][rows])
    fids = np.concatenate(all_fids)
    n = len(fids)
    cap = spec.capacity_per_shard
    if n > cap:
        raise ValueError(
            f"resharding table '{tname}' {old_shards}->1: the shard needs "
            f"{n} rows but capacity_per_shard is {cap}")
    trainer.engine.stores[tname].restore(
        fids, np.arange(n, dtype=np.int32), np.concatenate(all_tss),
        np.concatenate(all_counts))
    trainer.table_states[tname] = table_lib.state_from_np(
        spec, np.concatenate(pool_vals).reshape(n, spec.dim),
        {k: np.concatenate(v) for k, v in slot_vals.items()}, trainer.device)

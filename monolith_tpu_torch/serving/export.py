"""Model export for serving, in the JAX package's layout: an export written
by either package loads in the other's `ServingModel`.

There is no graph format to export: the serving "graph" is the task's
module plus the lookup path, so an export is the dense params, one row dump
per table with its fids, and metadata. Each segment's retriever (if any) is
baked into the values and its serving compressor applied column-wise;
`ServingModel` decompresses on load.

Layout:
    <dir>/export-<step>/
        meta.json
        dense.msgpack
        model_state.msgpack         BatchNorm's statistics, for a model
                                    with non-parameter state
        tables/<table>-s<k>.npz     shard k's fids + per-segment
                                    compressed blobs
    <dir>/EXPORT                    latest step pointer

A single-device trainer writes one `-s0` file a table and `"shards": 1`.
A trainer of S > 1 shards exports from every rank (each calls
`export_model`): rank r writes its own shard's live rows as `-s<r>`, rank
0 the dense state and `meta.json` with `"shards": S`, and barriers on the
trainer's gloo group come before the `EXPORT` pointer and after it, as the
JAX package's multi-process branch does. `ServingModel` merges the S files
at load. A bf16 training pool exports as f32 (widening is exact).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from monolith_tpu_torch import convert, serialization
from monolith_tpu_torch.data.framing import RecordReader, RecordWriter
from monolith_tpu_torch.embedding import table as table_lib
from monolith_tpu_torch.serving import codec


def export_model(trainer, directory: str, step: Optional[int] = None) -> str:
    """Export trainer state for serving; returns the export path. Only the
    live rows of the trainer's own shard are gathered on the device (K1 on
    the card) and copied back, in the store's order."""
    step = trainer.step if step is None else step
    path = os.path.join(directory, f"export-{step}")
    os.makedirs(os.path.join(path, "tables"), exist_ok=True)
    shards, own = trainer.engine.config.num_shards, trainer.engine.shard

    if own == 0:
        with open(os.path.join(path, "dense.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(
                convert.dense_tree(trainer.module.named_parameters())))
        serialization.save_model_state(path, trainer.model_state)

    meta = {"step": step, "ts": int(time.time()), "tables": {}}
    for tname, spec in trainer.engine.tables.items():
        seg_meta = [{"dim": s.dim, "compressor": s.compressor.name}
                    for s in spec.segments]
        meta["tables"][tname] = {"shards": shards, "dim": spec.dim,
                                 "capacity_per_shard": spec.capacity_per_shard,
                                 "segments": seg_meta}
        fids, rows, _, _ = trainer.engine.store_of(tname).save()
        if len(rows):
            with torch.no_grad():
                live = table_lib.lookup(
                    spec, trainer.table_states[tname],
                    torch.from_numpy(rows).to(trainer.device)).cpu().numpy()
        else:
            live = np.zeros((0, spec.dim), np.float32)
        arrays = {"fids": fids}
        off = 0
        for i, seg in enumerate(spec.segments):
            vals = live[:, off:off + seg.dim]
            if seg.retriever is not None:
                # bake quantization-aware retrieval into the export so that
                # serving sees the values training retrieved
                vals = np.asarray(seg.retriever.retrieve(vals, step),
                                  dtype=np.float32)
            for k, v in seg.compressor.compress(vals).items():
                arrays[f"seg{i}:{k}"] = np.asarray(v)
            off += seg.dim
        np.savez(os.path.join(path, "tables", f"{tname}-s{own}.npz"),
                 **arrays)

    if own == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    trainer._barrier()
    if own == 0:
        with open(os.path.join(directory, "EXPORT"), "w") as f:
            f.write(str(step))
    trainer._barrier()
    return path


def write_warmup_data(export_path: str, fid_batches, batches=None,
                      filename: str = "warmup.rec") -> str:
    """Write sample predict payloads next to an export, so that a serving
    replica can run them before it takes traffic. Each record is a codec
    payload in the framing of data/framing.py."""
    path = os.path.join(export_path, filename)
    batches = batches or [{} for _ in fid_batches]
    with open(path, "wb") as f:
        w = RecordWriter(f)
        for fid_batch, batch in zip(fid_batches, batches):
            payload = {f"fid:{k}": np.asarray(v, np.int64)
                       for k, v in fid_batch.items()}
            for k, v in (batch or {}).items():
                payload[f"batch:{k}"] = np.asarray(v)
            w.write(codec.pack(payload))
    return path


def read_warmup_data(export_path: str, filename: str = "warmup.rec"):
    """Yield (fid_batch, batch) pairs from a warmup file."""
    with open(os.path.join(export_path, filename), "rb") as f:
        for _, payload in RecordReader(f):
            req = codec.unpack(payload)
            fid_batch = {k[4:]: v for k, v in req.items() if k.startswith("fid:")}
            batch = {k[6:]: v for k, v in req.items() if k.startswith("batch:")}
            yield fid_batch, batch


def latest_export(directory: str) -> Optional[str]:
    p = os.path.join(directory, "EXPORT")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        step = int(f.read().strip())
    return os.path.join(directory, f"export-{step}")

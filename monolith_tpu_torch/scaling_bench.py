"""Weak-scaling harness of the sharded trainers: the port's counterpart of
the JAX package's `tools/scaling_bench.py`.

Runs the SAME per-rank workload at S = 1, 2, 4, 8 ranks (global batch = S
x per-rank batch, tables sharded over the ranks) and reports examples/s,
per-device efficiency against the one-rank run, total throughput against
it, the bytes each collective moves per rank in one step and the host
prepare per rank. S = 1 is the single-device `Trainer`; S > 1 is a
`ShardedTrainer` (`--trainer sharded`, `--exchange allgather|a2a`) or a
`MultiHostTrainer` (`--trainer multihost`, each rank fed its own slice) on
ranks that `parallel.launch` starts: NCCL, rank r on cuda:r (S up to the
cards), `--gloo-one-card` gloo ranks sharing cuda:0, `--cpu` gloo ranks on
the CPU. The workload is the JAX tool's: DeepFMTask(embedding_dim=16,
capacity_per_shard=2^16, hidden=(128, 64)), unique_cap = new_cap = 8192,
SyntheticCTR(200,000 users, 50,000 items, seed 3), 8 batches cycled, 3
warm steps and 24 timed.

Ranks that share one card (or the CPU) measure the software path of the
exchanges (the collectives, the host prepare, the launches), not scaling:
the card's work is serialised, so per-device efficiency is capped near 1/S
by construction. Only ranks on cards of their own give the hardware
scaling numbers; the JSON says which it is.

    python -m monolith_tpu_torch.scaling_bench [--cpu | --gloo-one-card]
        [--trainer sharded|multihost] [--exchange allgather|a2a]
        [--sizes 1,2,4,8] [per_device_batch]

prints a line per size and, last, one JSON object with the card's name
and power limit (nvidia-smi) beside the numbers. Efficiencies are against
the first size run (S = 1 unless `--sizes` leaves it out).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from monolith_tpu_torch.data.synthetic import SyntheticCTR
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

#: the collectives the step calls, by the JSON key of the bytes they move
COLLECTIVES = {"all_to_all_single": "a2a_bytes",
               "all_gather_into_tensor": "allgather_bytes",
               "reduce_scatter_tensor": "reduce_scatter_bytes"}
TASK = dict(embedding_dim=16, capacity_per_shard=1 << 16, hidden=(128, 64))
ENGINE = dict(unique_cap=8192, new_cap=8192)
DATA = dict(num_users=200_000, num_items=50_000, seed=3)
BATCHES, WARM, STEPS = 8, 3, 24


@contextlib.contextmanager
def count_collectives():
    """Counts, while it is open, the bytes of this rank's input to every
    all-to-all, all-gather and reduce-scatter that torch.distributed runs
    (the JAX tool counts each collective's per-device payload the same
    way), and their launches."""
    rec = {k: 0 for k in COLLECTIVES.values()}
    rec["collective_launches"] = 0
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def spy(name):
        def call(output, input, *a, **k):
            rec[COLLECTIVES[name]] += input.numel() * input.element_size()
            rec["collective_launches"] += 1
            return real[name](output, input, *a, **k)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, spy(name))
    try:
        yield rec
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_rows(pair, rank: int, n: int):
    fb, b = pair
    rows = len(b["label"]) // n
    cut = slice(rank * rows, (rank + 1) * rows)
    return ({k: v[cut] for k, v in fb.items()}, {k: v[cut] for k, v in b.items()})


def run(rank: int, n: int, per_dev_batch: int, trainer_kind: str,
        exchange: str, device: Optional[str] = None) -> Dict:
    """One rank of a run over n ranks (n = 1: the Trainer in this process
    on `device`). Returns {"step_s": seconds a step, "comm": one step's
    collective bytes, "host_prepare_ms": the median host prepare a
    step}."""
    cfg = TrainerConfig(engine=EngineConfig(num_shards=n, exchange=exchange,
                                            **ENGINE),
                        log_every=0, metrics_enabled=False)
    task = DeepFMTask(**TASK)
    if n == 1:
        trainer = Trainer(task, cfg, device=device)
    else:
        from monolith_tpu_torch.parallel import (MultiHostTrainer,
                                                 ShardedTrainer, make_mesh)
        from monolith_tpu_torch.parallel.launch import rank_device
        cls = MultiHostTrainer if trainer_kind == "multihost" else \
            ShardedTrainer
        trainer = cls(task, cfg, make_mesh(n, device=rank_device()))
    data = SyntheticCTR(batch_size=per_dev_batch * n, **DATA)
    batches = [data.batch() for _ in range(BATCHES)]
    if n > 1 and trainer_kind == "multihost":
        batches = [_rank_rows(p, rank, n) for p in batches]
    prepare_ms: List[float] = []
    real_pack = trainer._pack_full_wire

    def timed_pack(*a, **k):
        t0 = time.perf_counter()
        try:
            return real_pack(*a, **k)
        finally:
            prepare_ms.append((time.perf_counter() - t0) * 1e3)
    trainer._pack_full_wire = timed_pack
    with count_collectives() as comm:
        out = trainer.train_step(*batches[0])
        _sync(trainer.device)
    for pair in batches[1:1 + WARM]:
        out = trainer.train_step(*pair)
    float(out["loss"])
    _sync(trainer.device)
    prepare_ms.clear()
    t0 = time.perf_counter()
    for i in range(STEPS):
        out = trainer.train_step(*batches[i % len(batches)])
    loss = float(out["loss"])
    _sync(trainer.device)
    dt = (time.perf_counter() - t0) / STEPS
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss on rank {rank}: {loss}")
    return {"step_s": dt, "comm": dict(comm),
            "host_prepare_ms": float(np.median(prepare_ms))}


def card_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None
    where there is none."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else None


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(prog="monolith_tpu_torch.scaling_bench")
    parser.add_argument("per_device_batch", nargs="?", type=int, default=1024)
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU")
    parser.add_argument("--gloo-one-card", action="store_true",
                        help="gloo ranks sharing cuda:0")
    parser.add_argument("--trainer", default="sharded",
                        choices=["sharded", "multihost"])
    parser.add_argument("--exchange", default="allgather",
                        choices=["allgather", "a2a"])
    parser.add_argument("--sizes", default="1,2,4,8",
                        help="rank counts, cut to the ranks available")
    args = parser.parse_args(argv)
    from monolith_tpu_torch.parallel.launch import launch
    if args.cpu:
        where, available, backend = {"device": "cpu"}, os.cpu_count() or 1, \
            "cpu"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("scaling_bench runs on the cards and CUDA is "
                               "not available; pass --cpu")
        if args.gloo_one_card:
            where = {"backend": "gloo", "device": "cuda:0"}
            available = os.cpu_count() or 1
        else:
            where, available = {}, torch.cuda.device_count()
        backend = "cuda"
    shared = args.cpu or args.gloo_one_card
    sizes = [n for n in (int(x) for x in args.sizes.split(","))
             if n <= available]
    out = {"backend": backend, "card": None if args.cpu else card_line(),
           "per_device_batch": args.per_device_batch,
           "trainer": args.trainer, "exchange": args.exchange,
           "ranks_share_one_device": shared,
           "note": ("ranks share one device: the numbers measure the "
                    "software path of the exchanges, not scaling" if shared
                    else "one card a rank: hardware scaling")}
    base = None
    for n in sizes:
        job = (n, args.per_device_batch, args.trainer, args.exchange)
        if n == 1:
            ranks = [run(0, *job, device="cpu" if args.cpu else "cuda")]
        else:
            ranks = launch(run, n, args=job, **where)
        step_s = max(r["step_s"] for r in ranks)
        eps = args.per_device_batch * n / step_s
        base = eps if base is None else base
        cell = {"examples_per_sec": eps,
                "per_device_efficiency": eps / (base * n),
                "total_vs_mesh1": eps / base,
                "ms_per_step": step_s * 1e3,
                "host_prepare_ms": [r["host_prepare_ms"] for r in ranks],
                "per_device_step_comm": ranks[0]["comm"]}
        out[f"mesh{n}"] = cell
        print(f"mesh={n}: {eps:,.0f} ex/s  per-device eff="
              f"{cell['per_device_efficiency']:.1%}  total vs mesh1="
              f"{cell['total_vs_mesh1']:.2f}x  comm={cell['per_device_step_comm']}"
              f"  host prepare ms={cell['host_prepare_ms']}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

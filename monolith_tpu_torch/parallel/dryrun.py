"""The multi-rank dry run: every sharded code path, one short run each,
on S ranks. The port of the JAX package's `dryrun_multichip`
(`__graft_entry__.py`), case for case:

  a2a, allgather   a ShardedTrainer step on each exchange, then `train()`
                   with steps_per_dispatch=2 (blocks through the staging
                   lookahead);
  multihost        a MultiHostTrainer (ttl 1, async_optimize, bucket_cap
                   64): a step, a block through `train()`, evict_expired(10)
                   and a step that trains over the freed rows;
  multihost-bf16-multislot
                   the merged bf16 multislot model with stochastic
                   rounding (K3 on the card) on a MultiHostTrainer.

Tiny shapes; every loss must be finite. `dryrun_multichip(rank, n)` is a
rank's body: it runs under `parallel.launch` (which starts the n ranks) and
prints the JAX function's `dryrun_multichip(n, <case>): OK` lines on rank
0. The global batch is 8 rows a rank; the sharded trainers read all of it,
a multi-host rank its own 8.

    python -m monolith_tpu_torch.parallel.dryrun [--cpu] [--gloo-one-card] [n]

runs it on n ranks (default 2): NCCL, rank r on cuda:r; `--gloo-one-card`
puts gloo ranks on cuda:0; `--cpu` gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Iterator

import numpy as np
import torch

from monolith_tpu_torch.data.synthetic import SyntheticCTR, SyntheticMultiSlot
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.models.multislot import MultiSlotTask
from monolith_tpu_torch.parallel.launch import launch, rank_device
from monolith_tpu_torch.parallel.mesh import make_mesh
from monolith_tpu_torch.parallel.multihost import MultiHostTrainer
from monolith_tpu_torch.parallel.sharded import ShardedTrainer
from monolith_tpu_torch.training.trainer import TrainerConfig


def _rank_rows(pair, rank: int, n: int):
    """Rank `rank`'s rows of a global (fid_batch, batch)."""
    fb, b = pair
    rows = len(next(iter(b.values()))) // n
    cut = slice(rank * rows, (rank + 1) * rows)
    return ({k: v[cut] for k, v in fb.items()}, {k: v[cut] for k, v in b.items()})


def _own_rows(data, rank: int, n: int) -> Iterator:
    for pair in data:
        yield _rank_rows(pair, rank, n)


def _finite(x, what: str) -> float:
    v = float(x)
    if not np.isfinite(v):
        raise AssertionError(f"non-finite {what}: {v}")
    return v


def dryrun_multichip(rank: int, n: int) -> Dict[str, Dict[str, float]]:
    """One rank of the dry run over n ranks (the group is initialised, as
    `parallel.launch` leaves it). Returns each case's losses."""
    mesh = make_mesh(n, device=rank_device())
    say = print if rank == 0 else (lambda *a, **k: None)
    out = {}
    task = DeepFMTask(embedding_dim=8, capacity_per_shard=512, hidden=(16, 8))
    data = SyntheticCTR(num_users=64, num_items=32, batch_size=8 * n, seed=0)
    for exchange in ("a2a", "allgather"):
        cfg = TrainerConfig(engine=EngineConfig(num_shards=n, unique_cap=128,
                                                new_cap=128,
                                                exchange=exchange),
                            log_every=0)
        trainer = ShardedTrainer(task, cfg, mesh)
        loss = _finite(trainer.train_step(*data.batch())["loss"],
                       f"loss ({exchange})")
        # the block path through the public train() loop (staging
        # lookahead included)
        trainer.config.steps_per_dispatch = 2
        bl = _finite(trainer.train(iter(data), steps=4)["loss"],
                     f"block loss ({exchange})")
        out[exchange] = {"loss": loss, "block_loss": bl}
        say(f"dryrun_multichip({n}, {exchange}): OK, loss={loss:.4f} "
            f"block_loss={bl:.4f}", flush=True)

    ev_task = DeepFMTask(embedding_dim=8, capacity_per_shard=512,
                         hidden=(16, 8), ttl_seconds=1)
    cfg = TrainerConfig(engine=EngineConfig(num_shards=n, unique_cap=128,
                                            new_cap=128, bucket_cap=64,
                                            async_optimize=True),
                        log_every=0)
    trainer = MultiHostTrainer(ev_task, cfg, mesh)
    loss = _finite(trainer.train_step(*_rank_rows(data.batch(), rank, n),
                                      ts=1)["loss"], "multihost loss")
    trainer.config.steps_per_dispatch = 2
    bl = _finite(trainer.train(_own_rows(data, rank, n), steps=4)["loss"],
                 "multihost block loss")
    trainer.config.steps_per_dispatch = 1
    trainer.evict_expired(expire_before=10)
    zl = _finite(trainer.train_step(*_rank_rows(data.batch(), rank, n),
                                    ts=20)["loss"], "post-evict loss")
    out["multihost"] = {"loss": loss, "block_loss": bl, "post_evict_loss": zl}
    say(f"dryrun_multichip({n}, multihost): OK, loss={loss:.4f} "
        f"block_loss={bl:.4f} post_evict_loss={zl:.4f}", flush=True)

    ms_task = MultiSlotTask(num_tables=2, num_slots=4, embedding_dim=8,
                            capacity_per_shard=256, history_length=4,
                            hidden=(16,), merge=True,
                            table_dtype=torch.bfloat16,
                            stochastic_rounding=True)
    cfg = TrainerConfig(engine=EngineConfig(num_shards=n, unique_cap=128,
                                            new_cap=128, bucket_cap=64),
                        log_every=0)
    trainer = MultiHostTrainer(ms_task, cfg, mesh)
    ms_data = SyntheticMultiSlot(num_slots=4, vocab_per_slot=40,
                                 history_length=4, batch_size=8 * n, seed=0)
    loss = _finite(trainer.train_step(*_rank_rows(ms_data.batch(), rank,
                                                  n))["loss"],
                   "bf16 multislot loss")
    out["multihost-bf16-multislot"] = {"loss": loss}
    say(f"dryrun_multichip({n}, multihost-bf16-multislot): OK, "
        f"loss={loss:.4f}", flush=True)
    return out


def main(argv=None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser(prog="monolith_tpu_torch.parallel.dryrun")
    parser.add_argument("n", nargs="?", type=int, default=2)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--gloo-one-card", action="store_true")
    args = parser.parse_args(argv)
    if args.cpu:
        where = {"device": "cpu"}
    elif args.gloo_one_card:
        where = {"backend": "gloo", "device": "cuda:0"}
    else:
        where = {}
    return launch(dryrun_multichip, args.n, args=(args.n,), **where)[0]


if __name__ == "__main__":
    main(sys.argv[1:])

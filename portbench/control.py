"""Readings of the numbers that decide `correct`, from which their limits
are set (limits/<cell>.json), at the cell's own size on the card:

- the program's, on each of `--seeds`: from a training cell's set-up (the
  trainer, its first block through `Trainer.train`, the reference);
- the control's, on each of `--control-seeds`: the reference in the
  program's place with TF32 on, the precision below the configuration's
  float32 with TF32 off;
- the planted fault on the same seeds: the reference in the program's
  place with its loss taken over the first half of each batch.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3

Prints one JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, List

import torch

from portbench import compare, run
from portbench.reference import train as reference_train


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(ctx, control: bool) -> Dict:
    from portbench.drivers import train_replay as d
    K = ctx.cfg["steps_per_dispatch"]
    trainer, dense0 = d.build(ctx)
    world = ctx.stream.World(ctx.cfg, ctx.seed)
    batches = d.make_batches(world, K, ctx.cfg["batch_size"],
                             ctx.traffic["generator_threads"])
    observed = d.first_block(ctx, trainer, batches)
    del trainer
    _free(ctx.device)
    detail = {}
    ref, line = d.check(ctx, batches, dense0, observed, detail=detail)
    out = {"program": line, "program_worst": detail}
    if control:
        dense_np = {k: d._host(v) for k, v in dense0.items()}
        for name, kw in (("tf32", {"tf32": True}),
                         ("half_batch", {"fault": "half_batch"})):
            stand_in = reference_train.run(
                ctx.reference, ctx.cfg, batches[:K], dense0, ctx.seed,
                ctx.device, steps=K, **kw)
            detail = {}
            out[name] = compare.train_readings(stand_in, ref, dense_np,
                                               ctx.cfg, detail)
            out[name + "_worst"] = detail
    return out


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    files = run.cell_files(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = run.context(args.workload, files, seed, 0.0, False,
                          log=lambda s: print(s, file=sys.stderr))
        line = dict(train_readings(ctx, seed in control), seed=seed,
                    cell=args.workload)
        print(json.dumps(line), flush=True)
        _free(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`portbench.control` for the cells of drivers/train_replay_spans.py
(rows a vector alone; the reference's own `run`): readings of the numbers
that decide `correct`, from which the cell's limits are set, at its own
size on the card:

- the program's, on each of `--seeds`;
- the control's, on each of `--control-seeds`: the reference in the
  program's place with TF32 on, the precision below the configuration's
  float32 with TF32 off;
- the planted fault on the same seeds: the reference in the program's
  place with its loss taken over the first half of each batch.

    python3 -m portbench.control_vectors --workload dcnv2_criteo1tb.train \\
        --seeds 1,2,3 --control-seeds 1,2,3

Prints one JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from portbench import compare_vectors, run
from portbench.control import _free


def train_readings(ctx, control: bool) -> Dict:
    from portbench.drivers import train_replay as d
    from portbench.drivers import train_replay_spans as spans
    K = ctx.cfg["steps_per_dispatch"]
    with spans._train_replay_with_ours():
        trainer, dense0 = d.build(ctx)
        world = ctx.stream.World(ctx.cfg, ctx.seed)
        batches = d.make_batches(world, K, ctx.cfg["batch_size"],
                                 ctx.traffic["generator_threads"])
        observed = d.first_block(ctx, trainer, batches)
    del trainer
    _free(ctx.device)
    detail = {}
    ref, line = spans.check(ctx, batches, dense0, observed, detail=detail)
    out = {"program": line, "program_worst": detail}
    if control:
        dense_np = {k: d._host(v) for k, v in dense0.items()}
        for name, kw in (("tf32", {"tf32": True}),
                         ("half_batch", {"fault": "half_batch"})):
            stand_in = ctx.reference.run(ctx.cfg, batches[:K], dense0,
                                         ctx.seed, ctx.device, steps=K, **kw)
            detail = {}
            out[name] = compare_vectors.train_readings(stand_in, ref, dense_np,
                                                       ctx.cfg, detail)
            out[name + "_worst"] = detail
            del stand_in
            _free(ctx.device)
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

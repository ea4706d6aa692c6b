"""Config-driven training CLI of the port (the JAX package's train.py, the
rebuild's `local_train` binary), on the card unless `--cpu` is given:

    python -m monolith_tpu_torch.train --task deepfm --steps 1000 \\
        --batch_size 512 --model_dir /tmp/m --mode train_and_eval
    python -m monolith_tpu_torch.train --task movie_ranking \\
        --data movielens:examples/movielens/ratings.dat \\
        --mode train_and_eval --steps 800 --batch_size 512
    python -m monolith_tpu_torch.train --task din \\
        --task_args '{"seq_encoder": "dien"}' --steps 200
    python -m monolith_tpu_torch.train --task mypkg.mymod:MyTask \\
        --data 'files:/data/part-*.rec' --data_fmt pb_example_batch ...

Flags: RunnerConfig fields (model_dir, num_shards, unique_cap, ...) are
registered by config.extract_flags, as in the JAX package; --task picks a
zoo task by name or imports `module:Class`; --task_args passes JSON
kwargs; --data selects "synthetic" (default; the task-matched generator),
"files:<glob>" (with --data_fmt for the payload codec), "parquet:<path>"
or "movielens:<ratings file>". It prints the JAX CLI's one JSON line.

`--num_shards S > 1` in a process outside a torch.distributed group runs
the CLI's body in S ranks that `parallel.launch` starts (NCCL, rank r on
`cuda:r`, S at most the cards; with `--cpu`, gloo ranks on the CPU): each
rank builds the same data from the same argv, its Estimator builds a
`ShardedTrainer` of S shards over the global batch (the JAX CLI's
single-process mesh), and rank 0 prints the JSON line. Checkpoints and
exports are written per shard. Under a group another launcher started
(`torchrun`) the Estimator builds a `MultiHostTrainer`, as before:

    python -m monolith_tpu_torch.train --num_shards 4 --steps 1000 \
        --batch_size 4096 --model_dir /tmp/m
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Iterable

import torch.distributed as dist

from monolith_tpu_torch.config import extract_flags, parse_into
from monolith_tpu_torch.estimator import Estimator, RunnerConfig

ZOO = {
    "deepfm": ("monolith_tpu_torch.models.deepfm", "DeepFMTask"),
    "multislot": ("monolith_tpu_torch.models.multislot", "MultiSlotTask"),
    "ffm": ("monolith_tpu_torch.models.ffm", "FFMTask"),
    "din": ("monolith_tpu_torch.models.din", "DINTask"),
    "mmoe": ("monolith_tpu_torch.models.multitask", "MMoETask"),
    "dcn": ("monolith_tpu_torch.models.dcn", "DCNTask"),
    "autoint": ("monolith_tpu_torch.models.autoint", "AutoIntTask"),
    "movie_ranking": ("monolith_tpu_torch.models.movie_ranking",
                      "MovieRankingTask"),
}


def build_task(name: str, task_args: dict):
    if name in ZOO:
        mod, cls = ZOO[name]
    elif ":" in name:
        mod, cls = name.split(":", 1)
    else:
        raise SystemExit(f"--task must be one of {sorted(ZOO)} or module:Class,"
                         f" got {name!r}")
    return getattr(importlib.import_module(mod), cls)(**task_args)


def build_data(task, spec: str, fmt: str, batch_size: int,
               seed: int) -> Iterable:
    """Returns an iterable of (fid_batch, batch) trainer inputs."""
    from monolith_tpu_torch.data.datasets import (BatchedDataset, FileSource,
                                                  ParquetSource)
    if spec == "synthetic":
        # task-matched generators (the demo/bench path)
        from monolith_tpu_torch.data import synthetic
        from monolith_tpu_torch.models.multislot import MultiSlotTask
        if isinstance(task, MultiSlotTask):
            return synthetic.SyntheticMultiSlot(
                num_slots=task.num_slots, history_length=task.history_length,
                batch_size=batch_size, seed=seed)
        return synthetic.SyntheticCTR(batch_size=batch_size, seed=seed)
    lengths = {f.name: f.max_length for f in task.features()}
    if spec.startswith("files:"):
        src = FileSource(spec[len("files:"):], fmt=fmt)
    elif spec.startswith("parquet:"):
        fid_cols = {f.name: f.name for f in task.features()}
        src = ParquetSource(spec[len("parquet:"):], fid_columns=fid_cols,
                            label_column="label")
    elif spec.startswith("movielens:"):
        # ratings.dat / u.data ingestion (ref markdown/demo/ml_dataset.py);
        # see examples/movielens/ for the vendored quickstart sample
        from monolith_tpu_torch.data.movielens import MovieLensRatings
        names = tuple(f.name for f in task.features())
        if len(names) != 2:
            raise SystemExit(
                f"--data movielens: needs a (user, item) 2-feature task "
                f"(e.g. movie_ranking); --task {task.name} declares "
                f"{len(names)} features: {names}")
        return MovieLensRatings(path=spec[len("movielens:"):],
                                batch_size=batch_size, seed=seed,
                                feature_names=names)
    else:
        raise SystemExit(f"--data must be synthetic, files:<glob>, "
                         f"parquet:<path> or movielens:<ratings file>, "
                         f"got {spec!r}")
    return BatchedDataset(src, batch_size, lengths)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="monolith_tpu_torch.train",
        description="Train / evaluate / export a task with the PyTorch port",
        allow_abbrev=False)
    parser.add_argument("--task", default="deepfm")
    parser.add_argument("--task_args", default="{}",
                        help="JSON kwargs for the task dataclass")
    parser.add_argument("--mode", default="train",
                        choices=["train", "eval", "train_and_eval", "export"])
    parser.add_argument("--data", default="synthetic")
    parser.add_argument("--data_fmt", default="mtex",
                        help="files: payload codec (mtex / pb_instance / "
                             "pb_example / pb_example_batch)")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--eval_steps", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--export_dir", default="")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card; without "
                             "CUDA the run fails)")
    extract_flags(RunnerConfig, parser)
    return parser


def main(argv=None):
    """The CLI: runs its body here, or in `--num_shards` ranks that it
    launches (see the module docstring). Returns the printed results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args, _ = _parser().parse_known_args(argv)
    if args.num_shards > 1 and not dist.is_initialized():
        from monolith_tpu_torch.parallel.launch import launch
        return launch(rank_main, args.num_shards,
                      device="cpu" if args.cpu else None, args=(argv,))[0]
    return run(argv)


def rank_main(rank: int, argv) -> dict:
    """The CLI's body in rank `rank` of ranks `parallel.launch` started:
    a ShardedTrainer over the mesh of those ranks, on the rank's device."""
    from monolith_tpu_torch.parallel import make_mesh
    from monolith_tpu_torch.parallel.launch import rank_device
    return run(argv, mesh=make_mesh(device=rank_device()))


def run(argv, mesh=None) -> dict:
    """The CLI's body in this process (one rank of `mesh` when given);
    prints the JSON line unless it is a rank other than 0."""
    args, _ = _parser().parse_known_args(argv)
    task = build_task(args.task, json.loads(args.task_args))
    run_cfg = parse_into(RunnerConfig, argv)
    est = Estimator(task, run_cfg, device="cpu" if args.cpu else None,
                    mesh=mesh)
    data = build_data(task, args.data, args.data_fmt, args.batch_size,
                      run_cfg.seed)

    out = {}
    if args.mode in ("train", "train_and_eval"):
        out["train"] = est.train(iter(data), steps=args.steps)
    if args.mode in ("eval", "train_and_eval"):
        out["eval"] = est.evaluate(iter(data), steps=args.eval_steps)
    if args.mode == "export" or (args.export_dir and args.mode != "eval"):
        if not args.export_dir:
            raise SystemExit("--export_dir required for --mode export")
        out["export_path"] = est.export_saved_model(args.export_dir)
    if mesh is None or mesh.rank == 0:
        print(json.dumps({k: (v if isinstance(v, str)
                              else {m: round(float(x), 6)
                                    for m, x in v.items()})
                          for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

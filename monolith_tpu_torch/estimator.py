"""Estimator facade, the port of the JAX package's estimator.py (ref
estimator.py:250 Estimator): train / evaluate / predict /
export_saved_model over a task, with RunnerConfig (ref runner_utils.py:148)
collapsed to the knobs that apply.

`RunnerConfig` keeps the JAX package's fields and defaults, so that
`config.extract_flags` gives both packages' CLIs the same flags. The
trainer follows the JAX package's rule, in the port's terms of one process
a rank:
- a rank started by `parallel.launch` (the port's counterpart of the JAX
  package's one process over S local devices; `train.main` starts S of
  them for `--num_shards S`) is handed its `mesh`, and builds a
  `ShardedTrainer` of S shards: every rank reads the same global batch;
- under a torch.distributed group of more than one rank that another
  launcher started (e.g. `torchrun`; the CLI takes no flag for it, as in
  the JAX package) it builds a `MultiHostTrainer` with one shard a rank,
  whatever `num_shards` says, as the JAX package does for a multi-process
  run;
- otherwise the single-device `Trainer`, on the card unless the caller
  passes `device="cpu"`; `num_shards != 1` in one process is refused
  (`train.main` or `parallel.launch` start the ranks).
Checkpoints and exports of the sharded trainers are written per shard.

A restore is decided at construction (a checkpoint under `model_dir`) and
made when the first batch arrives, as in the JAX package. The port's
`checkpoint.restore` needs no step before it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Iterator, Optional, Sequence

import torch.distributed as dist

from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.training import checkpoint as ckpt_lib
from monolith_tpu_torch.training.task import RecTask
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig


@dataclasses.dataclass
class RunnerConfig:
    """ref runner_utils.py:148 RunnerConfig (subset that applies)."""
    model_dir: str = ""
    num_shards: int = 1            # table shards: 1 (N ranks run N)
    unique_cap: int = 8192
    new_cap: int = 8192
    clip_norm: float = 0.0
    seed: int = 0
    log_every: int = 100
    save_checkpoints_steps: int = 0
    enable_realtime_training: bool = False
    record_touch: bool = False
    # K steps per dispatch (Trainer.train_step_block); bit-identical to
    # sequential steps
    steps_per_dispatch: int = 1


class Estimator:
    def __init__(self, task: RecTask, config: RunnerConfig = RunnerConfig(),
                 device=None, mesh=None):
        """`mesh`: this rank's `parallel.Mesh` when `parallel.launch`
        started the ranks (a ShardedTrainer over it); `device` is then the
        mesh's."""
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        if mesh is not None:
            world = mesh.size
            if config.num_shards != world:
                raise ValueError(f"num_shards={config.num_shards} on a mesh "
                                 f"of {world} ranks")
        elif world == 1 and config.num_shards != 1:
            raise ValueError(
                f"num_shards={config.num_shards} in one process: the port "
                f"runs one process a rank; start the ranks with "
                f"monolith_tpu_torch.train.main (--num_shards "
                f"{config.num_shards}) or parallel.launch.launch, whose "
                f"ranks build a ShardedTrainer over their mesh")
        self.task = task
        self.config = config
        tc = TrainerConfig(
            engine=EngineConfig(num_shards=world,
                                unique_cap=config.unique_cap,
                                new_cap=config.new_cap,
                                record_touch=(config.record_touch
                                              or config.enable_realtime_training)),
            clip_norm=config.clip_norm, seed=config.seed,
            log_every=config.log_every,
            steps_per_dispatch=config.steps_per_dispatch)
        if mesh is not None:
            from monolith_tpu_torch.parallel import ShardedTrainer
            self.trainer = ShardedTrainer(task, tc, mesh)
        elif world > 1:
            from monolith_tpu_torch.parallel import MultiHostTrainer, make_mesh
            self.trainer = MultiHostTrainer(task, tc,
                                            make_mesh(device=device))
        else:
            self.trainer = Trainer(task, tc, device=device)
        self._restore_pending = bool(
            config.model_dir
            and ckpt_lib.latest_step(config.model_dir) is not None)

    def _maybe_restore(self) -> None:
        if self._restore_pending:
            ckpt_lib.restore(self.trainer, self.config.model_dir)
            self._restore_pending = False

    def _restored(self, data: Iterable) -> Iterator:
        """The stream, with its first batch taken and the pending restore
        made: a restore happens when data arrives, as in the JAX package."""
        it = iter(data)
        first = next(it)
        self._maybe_restore()
        return itertools.chain([first], it)

    def train(self, data: Iterable, steps: Optional[int] = None,
              hooks: Sequence = ()) -> Dict[str, float]:
        hooks = list(hooks)
        if self.config.model_dir and self.config.save_checkpoints_steps:
            from monolith_tpu_torch.training.hooks import CheckpointHook
            hooks.append(CheckpointHook(self.config.model_dir,
                                        self.config.save_checkpoints_steps))
        result = self.trainer.train(self._restored(data), steps=steps,
                                    hooks=hooks)
        if self.config.model_dir:
            ckpt_lib.save(self.trainer, self.config.model_dir)
        return result

    def evaluate(self, data: Iterable,
                 steps: Optional[int] = None) -> Dict[str, float]:
        return self.trainer.evaluate(self._restored(data), max_steps=steps)

    def predict(self, data: Iterable, steps: Optional[int] = None):
        """Yields the predictions of each batch, numpy [B]."""
        for i, (fid_batch, batch) in enumerate(data):
            if steps is not None and i >= steps:
                return
            self._maybe_restore()
            yield self.trainer.predict(fid_batch, batch).cpu().numpy()

    def export_saved_model(self, export_dir: str) -> str:
        from monolith_tpu_torch.serving.export import export_model
        return export_model(self.trainer, export_dir)


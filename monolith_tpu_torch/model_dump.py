"""Model and config archival for review and reproducibility (ref
model_dump/ dump_utils.py:46, which serializes the model's graphs and
feature configs for security review and reload), the port of the JAX
package's model_dump.py. Two artifacts:

1. The declarative config (`dump_model` / `save_model_dump`): tables,
   features, the dense parameters' paths and shapes in flax's names and
   orientation (Dense kernels [in, out]), their count, the engine config
   and the step, as JSON: the JAX package's dict for the same task.
2. The compute graph (`dump_graph` / `save_graph_dump`). The JAX package
   lowers its jitted forward, embedding lookup included, to StableHLO
   text. Here it is the text of a `torch.export` of the eval forward, from
   the POOLED features to the task's predictions: the module in eval mode
   (BatchNorm on its running statistics, no dropout) and the prediction
   function, with the parameters and buffers as the program's inputs. The
   row gather that feeds the pooled features is K1, a CUDA launch through
   ctypes on the card, which torch.export cannot see into; it is not
   registered as a `torch.library` op, so the graph starts after it. The
   embedding lookup is the same code for every task (engine.py), and the
   dump names the tables and features that it reads.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import torch

from monolith_tpu_torch import convert


def _dc_to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = _dc_to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [_dc_to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _dc_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _shapes(tree: Dict) -> Dict:
    return {k: _shapes(v) if isinstance(v, dict) else list(v.shape)
            for k, v in tree.items()}


def dump_model(trainer) -> Dict:
    """The archival dict of a trainer (call json.dump on it)."""
    task = trainer.task
    params = convert.dense_tree(trainer.module.named_parameters())
    return {
        "task": type(task).__name__,
        "task_config": _dc_to_dict(task) if dataclasses.is_dataclass(task)
        else repr(task),
        "tables": {name: _dc_to_dict(spec)
                   for name, spec in trainer.engine.tables.items()},
        "features": {name: _dc_to_dict(f)
                     for name, f in trainer.engine.features.items()},
        "engine_config": _dc_to_dict(trainer.config.engine),
        "step": trainer.step,
        "dense_param_shapes": _shapes(params),
        "dense_param_count": int(sum(
            a.size for a in convert._flatten(params).values())),
    }


def save_model_dump(trainer, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dump_model(trainer), f, indent=2, default=repr)


class _EvalForward(torch.nn.Module):
    def __init__(self, module, task):
        super().__init__()
        self.module, self.task = module, task

    def forward(self, pooled, batch):
        return self.task.predictions(self.module(pooled, batch))


def dump_graph(trainer, fid_batch, batch, ts: int = 0) -> str:
    """The text of a `torch.export` of the trainer's eval forward (see the
    module docstring for where it starts), traced on one batch. The
    batch's ids are prepared and looked up as an eval batch is (the host
    store admits unseen ids, as the JAX package's dump does); the program
    is traced, not run, and the parameters are not changed."""
    inputs, batch_t, _ = trainer._upload(fid_batch, batch, ts)
    with torch.no_grad():
        pooled, _ = trainer.engine.embed(trainer.table_states, inputs,
                                         step=trainer.step)
    trainer.module.eval()
    program = torch.export.export(_EvalForward(trainer.module, trainer.task),
                                  (pooled, batch_t))
    return str(program)


def save_graph_dump(trainer, path: str, fid_batch, batch,
                    ts: int = 0) -> None:
    with open(path, "w") as f:
        f.write(dump_graph(trainer, fid_batch, batch, ts=ts))

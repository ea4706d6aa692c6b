"""Carry a trainer's state across, as numpy arrays.

The state format is the JAX trainer's, in numpy:

    {"params":         flax params tree, e.g. {"deep": {"dense_0":
                       {"kernel": [in, out], "bias": [out]}, ...}},
     "sum_of_squares": optax adagrad's accumulators, the same tree,
     "tables":         {table: packed pool [1, cap, P] (or [cap, P])},
     "stores":         {table: HostStore.save() -> (fids, rows, tss, counts)},
     "step":           int}

`load_state` writes such a state into a port `Trainer` (kernels are
transposed into `nn.Linear`'s [out, in]); `export_state` reads a port
trainer back out in the same form, so a state also moves between two port
trainers (the card and the CPU). `jax_trainer_state` reads the JAX
package's trainer into the format with numpy alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax leaf path -> (nn.Module parameter name, transpose?)."""
    leaf = path[-1]
    if leaf == "kernel":
        return ".".join(path[:-1]) + ".weight", True
    if leaf == "bias":
        return ".".join(path[:-1]) + ".bias", False
    raise ValueError(f"no port counterpart for flax parameter {'/'.join(path)}")


def _to_module_tensors(tree) -> Dict[str, np.ndarray]:
    out = {}
    for path, arr in _flatten(tree).items():
        name, transpose = _torch_name(path)
        out[name] = arr.T if transpose else arr
    return out


def _to_flax_tree(named: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for name, arr in named.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = arr.T
        else:
            node[leaf] = arr
    return tree


@torch.no_grad()
def load_state(trainer, state: Dict) -> None:
    """Write a numpy state (format above) into a port Trainer, in place."""
    params = dict(trainer.module.named_parameters())
    for src, dst in ((state["params"], params),
                     (state["sum_of_squares"], trainer.opt_state)):
        named = _to_module_tensors(src)
        if set(named) != set(dst):
            raise ValueError(f"parameter names differ: {sorted(named)} vs "
                             f"{sorted(dst)}")
        for name, arr in named.items():
            if tuple(arr.shape) != tuple(dst[name].shape):
                raise ValueError(f"{name}: shape {arr.shape} != "
                                 f"{tuple(dst[name].shape)}")
            dst[name].copy_(torch.from_numpy(np.array(arr)))
    for tname, pool in state["tables"].items():
        data = trainer.table_states[tname]["data"]
        pool = np.array(pool, dtype=np.float32).reshape(data.shape)
        data.copy_(torch.from_numpy(pool))
    for tname, saved in state["stores"].items():
        trainer.engine.stores[tname].restore(*saved)
    trainer.step = int(state["step"])


def export_state(trainer) -> Dict:
    """Read a port Trainer's state out in the numpy format above."""
    def copy(t):  # never a view of the live (possibly CPU) tensor
        return t.detach().cpu().numpy().copy()

    params = {n: copy(p) for n, p in trainer.module.named_parameters()}
    sos = {n: copy(a) for n, a in trainer.opt_state.items()}
    return {"params": _to_flax_tree(params),
            "sum_of_squares": _to_flax_tree(sos),
            "tables": {t: copy(st["data"])[None]
                       for t, st in trainer.table_states.items()},
            "stores": {t: s.save() for t, s in trainer.engine.stores.items()},
            "step": trainer.step}


def jax_trainer_state(jax_trainer) -> Dict:
    """The JAX package's single-shard Trainer state in the numpy format
    (np.asarray on its arrays; nothing of JAX is imported here)."""
    sos = jax_trainer.opt_state[0].sum_of_squares  # scale_by_rss state
    return {"params": _to_flax_tree(_to_module_tensors(jax_trainer.params)),
            "sum_of_squares": _to_flax_tree(_to_module_tensors(sos)),
            "tables": {t: np.asarray(st["data"])
                       for t, st in jax_trainer.table_states.items()},
            "stores": {t: stores[0].save()
                       for t, stores in jax_trainer.engine.stores.items()},
            "step": int(jax_trainer.step)}

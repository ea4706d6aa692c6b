"""Hierarchical typed config + dataclass/CLI-flags bridge.

The port's copy of the JAX package's config.py: ref core/hyperparams.py:145 Params / :392
InstantiableParams (define/set/get/instantiate over a nested typed tree) and
gflags_utils.py:97 extract_flags / LinkDataclassToFlags (dataclass <-> flags
bridge; argparse here since absl isn't a dependency).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
from typing import Any, Dict, Optional, Sequence, Type


class Params:
    """A typed, nested parameter tree with define-before-set semantics."""

    def __init__(self):
        object.__setattr__(self, "_params", {})
        object.__setattr__(self, "_frozen", False)

    # --- definition / access ---

    def define(self, name: str, default: Any, help_str: str = "") -> None:
        if name in self._params:
            raise AttributeError(f"param {name!r} already defined")
        self._params[name] = default

    def __getattr__(self, name: str) -> Any:
        params = object.__getattribute__(self, "_params")
        if name in params:
            return params[name]
        raise AttributeError(f"no param {name!r}; defined: {sorted(params)}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name not in self._params:
            raise AttributeError(
                f"cannot set undefined param {name!r} (use define())")
        if self._frozen:
            raise AttributeError("params are frozen")
        self._params[name] = value

    def get(self, path: str) -> Any:
        """Dotted-path get: p.get("model.dim")."""
        cur: Any = self
        for part in path.split("."):
            cur = getattr(cur, part)
        return cur

    def set(self, **kwargs) -> "Params":
        """Chained set of (possibly dotted) keys."""
        for k, v in kwargs.items():
            if "." in k:
                head, _, rest = k.partition(".")
                getattr(self, head).set(**{rest: v})
            else:
                setattr(self, k, v)
        return self

    # --- structure ---

    def copy(self) -> "Params":
        return copy.deepcopy(self)

    def freeze(self) -> "Params":
        object.__setattr__(self, "_frozen", True)
        return self

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self._params.items():
            out[k] = v.to_dict() if isinstance(v, Params) else v
        return out

    def __repr__(self):
        return f"Params({self.to_dict()})"


class InstantiableParams(Params):
    """Params bound to a class; instantiate() constructs cls(params)
    (ref hyperparams.py:392)."""

    def __init__(self, cls: Optional[Type] = None):
        super().__init__()
        object.__setattr__(self, "_cls", cls)
        self.define("cls", cls)

    def instantiate(self, **kwargs):
        cls = self._params["cls"]
        if cls is None:
            raise ValueError("no class bound to InstantiableParams")
        return cls(self, **kwargs)


# --- dataclass <-> CLI flags bridge (ref gflags_utils.py:97) ---

def extract_flags(dc_cls, parser: Optional[argparse.ArgumentParser] = None,
                  prefix: str = "") -> argparse.ArgumentParser:
    """Register one CLI flag per dataclass field (bool/int/float/str fields;
    inherited fields from dataclass base chains are included — the
    reference's CpuTrainingConfig -> RunnerConfig inheritance pattern)."""
    # allow_abbrev=False: an unknown flag must never prefix-match a config
    # field (e.g. the CLI's --mode silently expanding to --model_dir and
    # training into a directory named after the mode value)
    parser = parser or argparse.ArgumentParser(allow_abbrev=False)
    for f in dataclasses.fields(dc_cls):
        if f.type in ("bool", bool):
            default = f.default if f.default is not dataclasses.MISSING else False
            parser.add_argument(f"--{prefix}{f.name}",
                                type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif f.type in ("int", int, "float", float, "str", str):
            ty = {"int": int, int: int, "float": float, float: float,
                  "str": str, str: str}[f.type]
            default = f.default if f.default is not dataclasses.MISSING else None
            parser.add_argument(f"--{prefix}{f.name}", type=ty, default=default)
        # complex fields (nested dataclasses, tuples) are not CLI-settable
    return parser


def parse_into(dc_cls, argv: Optional[Sequence[str]] = None, prefix: str = ""):
    """Parse argv into a new dataclass instance (unknown flags ignored)."""
    parser = extract_flags(dc_cls, prefix=prefix)
    ns, _ = parser.parse_known_args(argv)
    known = {f.name for f in dataclasses.fields(dc_cls)}
    kwargs = {k[len(prefix):] if prefix else k: v
              for k, v in vars(ns).items()
              if (k[len(prefix):] if prefix else k) in known and v is not None}
    return dc_cls(**kwargs)

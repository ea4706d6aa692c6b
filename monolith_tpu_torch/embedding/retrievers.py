"""Training-time quantization-aware retrieval of embedding rows.

A retriever is a differentiable transform of the looked-up unique-row
buffer, applied inside the loss (`engine.retrieve_unique`), so autograd
produces its backward; export and the streaming push apply it to host rows
so that serving sees the values training retrieved.

  - FakeQuant: forward snaps each float to an int8 grid (round half away
    from zero, `trunc(x / s + sign(x) * 0.5)`, then clip to [-128, 127];
    not `torch.round`, which rounds half to even); backward is
    straight-through, a `torch.autograd.Function` (the JAX package's is a
    `jax.custom_vjp`).
  - HashNet: forward = amplitude * tanh(scale * x), with
    scale = init * (1 + gamma * step)^power capped at max_scale and held
    between multiples of `step_size`; backward comes from autograd.

`retrieve(x, step)` takes a torch tensor (training) or a numpy array
(export, streaming: rows on the host) and returns the same kind. `step` is
the trainer's step number, a Python int; `HashNet.scale` computes in numpy
f32 in the JAX package's operation order, like the port's learning-rate
schedules, and returns a host float.

Retrievers are configured per TableSegment (`TableSegment.retriever`); a
segment with None passes through untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Retriever:
    name: str = "raw"

    def retrieve(self, x, step: int):
        return x


def _fake_quant(x, step_size: float):
    """The int8 grid snap on a torch tensor or a numpy array (f32)."""
    if isinstance(x, torch.Tensor):
        n = torch.trunc(x / step_size + torch.sign(x) * 0.5)
        return torch.clamp(n, -128.0, 127.0) * step_size
    x = np.asarray(x, dtype=np.float32)
    s = np.float32(step_size)
    n = np.trunc(x / s + np.sign(x) * np.float32(0.5))
    return np.clip(n, np.float32(-128.0), np.float32(127.0)) * s


class _FakeQuantSTE(torch.autograd.Function):
    """Forward: the grid snap; backward: the incoming gradient unchanged."""

    @staticmethod
    def forward(ctx, x, step_size):
        return _fake_quant(x, step_size)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class FakeQuant(Retriever):
    """Quantization-aware training to an int8 grid over [-r, r]
    (step = r / 128, slots [-128, 127])."""
    name: str = "fake_quant"
    r: float = 1.0

    @property
    def step_size(self) -> float:
        return self.r / 128.0

    def retrieve(self, x, step: int):
        if isinstance(x, torch.Tensor):
            return _FakeQuantSTE.apply(x, self.step_size)
        return _fake_quant(x, self.step_size)


@dataclasses.dataclass(frozen=True)
class HashNet(Retriever):
    """HashNet continuation quantization: amplitude * tanh(scale * x)."""
    name: str = "hash_net"
    amplitude: float = 1.0
    init_scale: float = 1.0
    max_scale: float = 10.0
    step_size: int = 1000
    gamma: float = 0.005
    power: float = 0.5

    def scale(self, step: int) -> float:
        """The scale at `step`: recomputed at multiples of step_size and
        held in between."""
        f32 = np.float32
        eff = np.floor(f32(step) / f32(self.step_size)) * f32(self.step_size)
        s = f32(self.init_scale) * np.power(
            f32(1.0) + f32(self.gamma) * eff, f32(self.power))
        return float(min(s, f32(self.max_scale)))

    def retrieve(self, x, step: int):
        scale = self.scale(step)
        if isinstance(x, torch.Tensor):
            return self.amplitude * torch.tanh(scale * x)
        x = np.asarray(x, dtype=np.float32)
        return np.float32(self.amplitude) * np.tanh(np.float32(scale) * x)


NAMED_RETRIEVERS = {
    "raw": Retriever,
    "fake_quant": FakeQuant,
    "hash_net": HashNet,
}

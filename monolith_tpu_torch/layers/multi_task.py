"""Multi-task layers (ref layers/multi_task.py): MMoE (:34) and SNR
(:308), the port of the JAX package's layers/multi_task.py."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from monolith_tpu_torch.layers import initializers as init
from monolith_tpu_torch.layers.draws import Drawing, uniform
from monolith_tpu_torch.layers.mlp import MLP


class MMoE(nn.Module):
    """Multi-gate mixture of experts: per-task gates (Dense `gate_{t}`)
    over shared expert MLPs (`expert_{i}`, activated last). Returns (the
    task outputs, aux_loss).

    gate_type "topk" keeps every logit >= the k-th largest of its row (ties
    included, as the JAX layer's sorted threshold does) and masks the rest
    with -1e9. With any gate_type other than "softmax" the auxiliary loss
    sums, over tasks, the CV^2 of the gates' importance: the population
    variance over the squared mean, as `jnp.var` computes it."""

    def __init__(self, input_dim: int, num_tasks: int, num_experts: int,
                 expert_output_dims: Sequence[int],
                 gate_type: str = "softmax", top_k: int = 2,
                 gate_input_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_tasks, self.num_experts = num_tasks, num_experts
        self.gate_type, self.top_k = gate_type, top_k
        for i in range(num_experts):
            setattr(self, f"expert_{i}", MLP(
                input_dim, tuple(expert_output_dims), generator=generator,
                activate_last=True))
        gate_in = input_dim if gate_input_dim is None else gate_input_dim
        for t in range(num_tasks):
            setattr(self, f"gate_{t}", init.dense(gate_in, num_experts,
                                                  generator))

    def forward(self, expert_input: torch.Tensor,
                gate_input: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        gate_input = expert_input if gate_input is None else gate_input
        experts = torch.stack(
            [getattr(self, f"expert_{i}")(expert_input)
             for i in range(self.num_experts)], dim=2)  # [B, D, E]
        aux_loss = torch.zeros((), device=expert_input.device)
        outs = []
        for t in range(self.num_tasks):
            logits = getattr(self, f"gate_{t}")(gate_input)
            if self.gate_type == "topk":
                thresh = torch.sort(logits, dim=-1).values[:, -self.top_k]
                logits = torch.where(logits >= thresh[:, None], logits,
                                     torch.full((), -1e9, dtype=logits.dtype,
                                                device=logits.device))
            gates = torch.softmax(logits, dim=-1)  # [B, E]
            if self.gate_type != "softmax":
                importance = gates.sum(dim=0)
                var = importance.var(correction=0)
                aux_loss = aux_loss + var / torch.square(importance.mean()
                                                         + 1e-9)
            outs.append(torch.einsum("bde,be->bd", experts, gates))
        return outs, aux_loss


class SNR(Drawing):
    """Sub-Network Routing (ref :308): learned stochastic binary (hard
    concrete) connections between `num_in_subnet` input sub-networks of
    width `in_dim` and `num_out_subnet` outputs of width `out_subnet_dim`.
    forward(list of [B, in_dim]) -> list of [B, out_subnet_dim].

    The gate z = clip(s * (zeta - gamma) + gamma, 0, 1) of each (in, out)
    pair, with log-alpha `snr_log_alpha` (zeros at init): s =
    sigmoid((log u - log(1 - u) + log_alpha) / beta), u uniform in
    [1e-6, 1 - 1e-6) drawn from the layer's generator, when it is
    stochastic; s = sigmoid(log_alpha) otherwise. "trans" routes through
    gated matrices `snr_weight` [n_in * n_out, in_dim, out_dim]
    (glorot-normal); "aver" sums the gated inputs (in_dim == out_dim).

    As in the JAX layer, whether the gate draws is the constructor's
    `training` (default True), not the module's train / eval mode; it is
    kept as `stochastic`, since `training` is nn.Module's mode."""

    def __init__(self, num_in_subnet: int, in_dim: int, num_out_subnet: int,
                 out_subnet_dim: int, snr_type: str = "trans",
                 zeta: float = 1.1, gamma: float = -0.1, beta: float = 0.667,
                 training: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if snr_type not in ("trans", "aver"):
            raise ValueError(f"unknown snr_type {snr_type}")
        if snr_type == "aver":
            assert in_dim == out_subnet_dim
        self.n_in, self.n_out = num_in_subnet, num_out_subnet
        self.snr_type, self.stochastic = snr_type, training
        self.zeta, self.gamma, self.beta = zeta, gamma, beta
        n = num_in_subnet * num_out_subnet
        self.snr_log_alpha = init.param(init.zeros, (n,))
        if snr_type == "trans":
            self.snr_weight = init.param(
                init.glorot_normal, (n, in_dim, out_subnet_dim), generator)

    def gate(self, device) -> torch.Tensor:
        """z [n_in * n_out]."""
        log_alpha = self.snr_log_alpha
        if self.stochastic:
            u = uniform(log_alpha.shape, self.draw_generator(), device,
                        1e-6, 1 - 1e-6)
            s = torch.sigmoid((torch.log(u) - torch.log(1 - u) + log_alpha)
                              / self.beta)
        else:
            s = torch.sigmoid(log_alpha)
        return torch.clamp(s * (self.zeta - self.gamma) + self.gamma,
                           0.0, 1.0)

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        z = self.gate(inputs[0].device)
        if self.snr_type == "aver":
            zmat = z.reshape(self.n_in, self.n_out)
            return [sum(zmat[i, j] * inputs[i] for i in range(self.n_in))
                    for j in range(self.n_out)]
        w = self.snr_weight * z[:, None, None]
        x = torch.stack(inputs, dim=1)  # [B, n_in, in_dim]
        w4 = w.reshape(self.n_in, self.n_out, *w.shape[1:])
        out = torch.einsum("bni,niod->bod", x, w4.permute(0, 2, 1, 3))
        return [out[:, j] for j in range(self.n_out)]

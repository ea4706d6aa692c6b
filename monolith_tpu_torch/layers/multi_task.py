"""Multi-task layers (ref layers/multi_task.py): MMoE (:34), the port of
the JAX package's layers/multi_task.py. SNR (:308) is not ported: it draws
from a random stream in training only, and the port's modules have no
training flag yet (ROADMAP item 10(a))."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from monolith_tpu_torch.layers import initializers as init
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

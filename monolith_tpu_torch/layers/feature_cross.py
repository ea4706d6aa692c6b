"""Feature-cross layers (ref layers/feature_cross.py): GroupInt/FFM (:37),
AllInt (:151), CDot (:242), CAN (:345) and DCN vector/matrix/mixed (:445),
the port of the JAX package's layers/feature_cross.py, over [B, F, D]
stacked or [B, F*D] flat field embeddings."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from monolith_tpu_torch.layers import activations
from monolith_tpu_torch.layers import initializers as init
from monolith_tpu_torch.layers.draws import Drawing, dropout
from monolith_tpu_torch.layers.mlp import MLP
from monolith_tpu_torch.ops.interactions import ffm_interaction


class GroupInt(nn.Module):
    """Pairwise interaction of grouped (sum-pooled) field embeddings, with
    optional AFM-style attention (the MLP `groupint_attention_mlp`, units
    `attention_units` ending in 1) over the crossed products.

    forward((left [B, F1*D], right [B, F2*D])) ->
      multiply: [B, F1*F2*D] (attention-weighted if use_attention)
      dot:      [B, F1*F2]
    """

    def __init__(self, dim_size: int, interaction_type: str = "multiply",
                 use_attention: bool = False,
                 attention_units: Sequence[int] = (8, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim_size, self.interaction_type = dim_size, interaction_type
        self.use_attention = (interaction_type == "multiply"
                              and use_attention)
        if self.use_attention:
            assert attention_units[-1] == 1
            self.groupint_attention_mlp = MLP(
                dim_size, tuple(attention_units), generator=generator)

    def forward(self, inputs) -> torch.Tensor:
        left, right = inputs
        out = ffm_interaction(left, right, self.dim_size,
                              self.interaction_type)
        if self.use_attention:
            b = out.shape[0]
            nf = out.shape[1] // self.dim_size
            stacked = out.reshape(b, nf, self.dim_size)
            attn = self.groupint_attention_mlp(stacked)  # [B, nf, 1]
            out = (stacked * attn).reshape(b, nf * self.dim_size)
        return out


FFM = GroupInt


class AllInt(nn.Module):
    """All-interaction with a learned compression matrix `allint_kernel`
    C [F, cmp_dim] (glorot-normal) and `allint_bias`:
    O = X @ (X^T C + b), X: [B, F, D] -> [B, F*cmp_dim] ([B, F, cmp_dim]
    without `flatten`)."""

    def __init__(self, num_fields: int, cmp_dim: int, use_bias: bool = True,
                 flatten: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.flatten = flatten
        self.allint_kernel = init.param(init.glorot_normal,
                                        (num_fields, cmp_dim), generator)
        self.allint_bias = (init.param(init.zeros, (cmp_dim,))
                            if use_bias else None)

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        b, f, _ = embeddings.shape
        comp = torch.einsum("bfd,fc->bdc", embeddings, self.allint_kernel)
        if self.allint_bias is not None:
            comp = comp + self.allint_bias
        inter = torch.einsum("bfd,bdc->bfc", embeddings, comp)
        return inter.reshape(b, -1) if self.flatten else inter


class CDot(nn.Module):
    """Data-dependent compression cross: project the fields with the
    learned `project_weight` [F, P] (glorot-normal), compress through the
    MLP `compress_tower` (ReLU, units `compress_units` then D*P), cross
    back; output [B, F*P + D*P]. (The JAX layer's `activation` field is
    never read, so the port has none.)"""

    def __init__(self, num_fields: int, dim: int, project_dim: int,
                 compress_units: Sequence[int] = (64,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.project_dim = project_dim
        self.project_weight = init.param(init.glorot_normal,
                                         (num_fields, project_dim), generator)
        self.compress_tower = MLP(dim * project_dim,
                                  (*compress_units, dim * project_dim),
                                  generator=generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        b, f, d = inputs.shape
        p = self.project_dim
        projected = torch.einsum("bfd,fp->bdp", inputs, self.project_weight)
        compressed = self.compress_tower(projected.reshape(b, d * p))
        crossed = torch.einsum("bfd,bdp->bfp", inputs,
                               compressed.reshape(b, d, p))
        return torch.cat([crossed.reshape(b, f * p), compressed], dim=1)


class CAN(nn.Module):
    """Co-Action Network unit: the item embedding is reshaped into
    per-example MLP weights applied to the user embedding. No parameters.

    user: [B, U] (or [B, T, U] if is_seq); item: [B, layer_num*(U*U + U)].
    """

    def __init__(self, layer_num: int = 2, activation: str = "tanh",
                 is_seq: bool = False):
        super().__init__()
        self.layer_num, self.is_seq = layer_num, is_seq
        self.act = activations.get(activation)

    def forward(self, inputs) -> torch.Tensor:
        user, item = inputs
        u = user.shape[-1]
        assert item.shape[-1] == self.layer_num * (u * u + u), \
            (f"item dim {item.shape[-1]} != layer_num*(U^2+U) = "
             f"{self.layer_num * (u * u + u)}")
        x = user if self.is_seq else user[:, None, :]  # [B, T, U]
        off = 0
        for _ in range(self.layer_num):
            w = item[:, off:off + u * u].reshape(-1, u, u)
            off += u * u
            bias = item[:, off:off + u].reshape(-1, 1, u)
            off += u
            x = self.act(torch.einsum("btu,buv->btv", x, w) + bias)
        return x.sum(dim=1) if self.is_seq else x[:, 0, :]


class DCN(Drawing):
    """Deep & Cross v1/v2/mixed over [B, D] (ref :445, dcn_type vector |
    matrix | mixed), parameters glorot-normal, biases zero:
      vector: x' = x0 * (x.w) + b + x          (`kernel_{i}` [D, 1])
      matrix: x' = x0 * (W x + b) + x          (`kernel_{i}` [D, D])
      mixed:  low-rank experts `U_{i}_{j}`, `V_{i}_{j}` [D, low_rank] with
              softmax gates `gate_{i}` [D, num_experts] (DCN-V2 mixed).
    With `use_dropout`, each layer's output goes through flax's dropout
    (keep `keep_prob`, scale 1 / keep_prob) in train mode only, drawn from
    the layer's generator (layers/draws.py)."""

    def __init__(self, dim: int, layer_num: int = 1, dcn_type: str = "matrix",
                 num_experts: int = 1, low_rank: int = 0,
                 use_dropout: bool = False, keep_prob: float = 0.95,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dcn_type not in ("vector", "matrix", "mixed"):
            raise ValueError(f"unknown dcn_type {dcn_type}")
        self.layer_num, self.dcn_type = layer_num, dcn_type
        self.num_experts = num_experts
        self.use_dropout, self.keep_prob = use_dropout, keep_prob
        g, gn = generator, init.glorot_normal
        for i in range(layer_num):
            if dcn_type == "mixed":
                assert low_rank > 0
                for j in range(num_experts):
                    setattr(self, f"U_{i}_{j}", init.param(gn, (dim, low_rank),
                                                           g))
                    setattr(self, f"V_{i}_{j}", init.param(gn, (dim, low_rank),
                                                           g))
                setattr(self, f"gate_{i}", init.param(gn, (dim, num_experts),
                                                      g))
            else:
                width = 1 if dcn_type == "vector" else dim
                setattr(self, f"kernel_{i}", init.param(gn, (dim, width), g))
                setattr(self, f"bias_{i}", init.param(init.zeros, (dim,)))

    def _cross(self, i: int, x0: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
        if self.dcn_type == "mixed":
            stacked = torch.stack(
                [x0 * ((x @ getattr(self, f"V_{i}_{j}"))
                       @ getattr(self, f"U_{i}_{j}").T)
                 for j in range(self.num_experts)], dim=-1)  # [B, D, E]
            gates = torch.softmax(x @ getattr(self, f"gate_{i}"),
                                  dim=-1)                    # [B, E]
            return torch.einsum("bde,be->bd", stacked, gates) + x
        w, b = getattr(self, f"kernel_{i}"), getattr(self, f"bias_{i}")
        if self.dcn_type == "vector":
            return x0 * (x @ w) + b + x
        return x0 * (x @ w + b) + x

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.layer_num):
            x = self._cross(i, x0, x)
            if self.use_dropout and self.training:
                x = dropout(x, self.keep_prob, self.draw_generator())
        return x

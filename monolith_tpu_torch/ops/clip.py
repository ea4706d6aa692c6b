"""Global-norm gradient clipping over a dict of tensors.

The port of monolith_tpu/ops/clip.py: the norm is taken in f32 over every
leaf, the whole tree is scaled by min(1, clip_norm / max(norm, 1e-12)), and
each leaf is cast back to its own dtype after the f32 product (so a bf16
leaf rounds once, as the JAX package's does). Plain PyTorch: the JAX package
has no kernel here either. Nothing is read back from the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), f32, a 0-dim tensor on the
    leaves' device (on the CPU for an empty tree)."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], clip_norm: float,
                        use_norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale the whole tree so that its global norm is <= clip_norm.
    Returns (clipped tree, norm); `use_norm` replaces the tree's own norm."""
    norm = (global_norm(tree) if use_norm is None
            else torch.as_tensor(use_norm, dtype=torch.float32))
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, norm

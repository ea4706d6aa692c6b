"""The sharded trainer on torch.distributed: one process a rank."""

from monolith_tpu_torch.parallel.mesh import Mesh, make_mesh
from monolith_tpu_torch.parallel.sharded import ShardedTrainer

__all__ = ["Mesh", "make_mesh", "ShardedTrainer"]

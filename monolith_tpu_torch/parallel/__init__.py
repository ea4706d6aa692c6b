"""The sharded and multi-host trainers on torch.distributed: one process a
rank."""

from monolith_tpu_torch.parallel.mesh import Mesh, make_mesh
from monolith_tpu_torch.parallel.multihost import MultiHostTrainer
from monolith_tpu_torch.parallel.sharded import ShardedTrainer

__all__ = ["Mesh", "make_mesh", "MultiHostTrainer", "ShardedTrainer"]

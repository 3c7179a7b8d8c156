"""Multi-device execution over torch.distributed: the (seed × agent)
mesh (port of reina_tpu/parallel)."""
from .mesh import init_distributed, make_mesh, shard_run  # noqa: F401

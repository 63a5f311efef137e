"""Data parallelism of the port (``morefusion_tpu.parallel``): the data
mesh and the host-object collectives on ``torch.distributed``."""

# flake8: noqa: F401
from .mesh import DataMesh
from .mesh import data_mesh
from .mesh import replicate
from .mesh import shard_batch
from .mesh import local_batch_slice
from .distributed import barrier
from .distributed import broadcast_obj
from .distributed import gather_obj
from .distributed import is_primary
from .distributed import maybe_initialize

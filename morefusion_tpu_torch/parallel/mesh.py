"""The data mesh: one-dimensional data parallelism, one process a card.

Port of ``morefusion_tpu/parallel/mesh.py``. The reference's only
parallelism is multi-process data parallelism (ChainerMN pure_nccl); JAX
builds it as a 1-D ``Mesh('data')`` with the batch sharded over it. Here
each rank is one process on one device (``torchrun``), so the mesh is that
process's view of it: the world size, its rank and its device. A rank holds
the rows ``local_batch_slice(B)`` of every global batch of ``B``;
parameters are replicated from rank 0 and their gradients averaged by DDP
(``training.trainer.make_dp_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from . import distributed


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the data-parallel world."""

    world_size: int
    rank: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        """True under a process group (even of one rank): the steps then
        average over the group."""
        return dist.is_initialized()


def data_mesh(device: Optional[str] = None) -> DataMesh:
    """The mesh of the default process group (world size 1 and rank 0
    without one) on ``device`` (default: ``cuda:LOCAL_RANK`` where CUDA is
    available, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return DataMesh(world_size=distributed.world_size(),
                    rank=distributed.rank(),
                    device=distributed.local_device(device))


def local_batch_slice(global_batch_size: int,
                      mesh: Optional[DataMesh] = None) -> slice:
    """This rank's slice of a global batch (the reference's
    ``chainermn.scatter_dataset`` role), with JAX's arithmetic: ``B // W``
    rows at ``rank * (B // W)``."""
    n = mesh.world_size if mesh is not None else distributed.world_size()
    r = mesh.rank if mesh is not None else distributed.rank()
    per = global_batch_size // n
    return slice(r * per, (r + 1) * per)


def shard_batch(batch, mesh: DataMesh):
    """This rank's rows of a host batch (a dict of arrays or tensors of
    the global batch), as tensors on its device."""
    first = next(iter(batch.values()))
    rows = local_batch_slice(len(first), mesh)
    return {k: torch.as_tensor(v[rows]).to(mesh.device)
            for k, v in batch.items()}


def replicate(tree, mesh: DataMesh):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, a tensor, or a list / tuple / dict of tensors. Returns
    ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    if mesh.world_size > 1:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)
    return tree

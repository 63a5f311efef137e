"""Process-group initialization and host-object collectives.

Port of ``morefusion_tpu/parallel/distributed.py`` on ``torch.distributed``.
The reference's ChainerMN roles and their equivalents here:

  create_communicator -> :func:`maybe_initialize` (one process a card)
  scatter_dataset     -> the per-rank batch slice (``local_batch_slice``)
  allreduce grads     -> DDP's gradient average in the data-parallel step
  bcast_obj / gather_obj -> :func:`broadcast_obj` / :func:`gather_obj`

Every function works without a process group (one process): then the rank
is 0, the world size 1 and the collectives return their input.
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

#: how long a rendezvous or a collective may wait for the other ranks
TIMEOUT = datetime.timedelta(minutes=20)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def maybe_initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Initialize the default process group where a multi-process run is
    asked for, by ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or by the arguments,
    which win over it. With neither, or with an already initialized group,
    it does nothing and returns False, so the same script runs in one
    process and under ``torchrun``.

    The backend is ``nccl`` where CUDA is available and ``gloo`` otherwise,
    unless ``backend`` names one; under ``nccl`` the process's current
    device becomes ``cuda:LOCAL_RANK``. ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank or 0))
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and world_size in (None, 1):
        return False
    if init_method is None:
        raise ValueError(
            f"world size {world_size} needs an init_method or MASTER_ADDR")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size or 1,
        rank=rank or 0, timeout=TIMEOUT)
    return True


def free_port() -> int:
    """A TCP port of this host that is free now (for a ``tcp://127.0.0.1``
    rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def initialize_single(device: str = "cuda") -> bool:
    """A process group of this one process (``nccl`` for a card, ``gloo``
    for the CPU) unless one exists, so that the data-parallel steps run
    their collectives at world size 1; returns whether it made one."""
    return maybe_initialize(
        init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
        backend="nccl" if torch.device(device).type == "cuda" else "gloo")


def local_device(device: str = "cuda") -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` for ``"cuda"``
    (``cuda:0`` without ``torchrun``), else ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def is_primary() -> bool:
    """The rank-0-only I/O gate."""
    return rank() == 0


def barrier() -> None:
    """Block until every rank reaches this point (a no-op in one
    process)."""
    if world_size() > 1:
        dist.barrier()


def _obj_to_array(obj: Any, size: int) -> np.ndarray:
    data = pickle.dumps(obj)
    if len(data) > size - 8:
        raise ValueError(f"object too large: {len(data)} > {size - 8}")
    buf = np.zeros(size, np.uint8)
    buf[:8] = np.frombuffer(np.int64(len(data)).tobytes(), dtype=np.uint8)
    buf[8:8 + len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf


def _array_to_obj(buf: np.ndarray) -> Any:
    n = int(np.frombuffer(buf[:8].tobytes(), dtype=np.int64)[0])
    return pickle.loads(buf[8:8 + n].tobytes())


def _collective_device() -> torch.device:
    """Where the group's tensors must lie: the current card under nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_obj(obj: Any, size: int = 1 << 20) -> Any:
    """A picklable object of rank 0 on every rank (``comm.bcast_obj``).

    The object travels as a fixed ``size``-byte uint8 buffer with an 8-byte
    length prefix, as in JAX's; every rank packs its own argument first, so
    an object over ``size - 8`` pickled bytes raises ``ValueError`` on the
    rank that holds it before any collective runs."""
    if world_size() == 1:
        return obj
    buf = torch.from_numpy(_obj_to_array(obj if is_primary() else None, size))
    buf = buf.to(_collective_device())
    dist.broadcast(buf, src=0)
    return _array_to_obj(buf.cpu().numpy())


def gather_obj(obj: Any, size: int = 1 << 20) -> Optional[List[Any]]:
    """The list of every rank's picklable object on rank 0, None on the
    others (``comm.gather_obj``: the evaluation's record collection). The
    same fixed-size buffer as :func:`broadcast_obj`, gathered to all
    ranks."""
    if world_size() == 1:
        return [obj]
    buf = torch.from_numpy(_obj_to_array(obj, size)).to(_collective_device())
    bufs = [torch.empty_like(buf) for _ in range(world_size())]
    dist.all_gather(bufs, buf)
    if not is_primary():
        return None
    return [_array_to_obj(b.cpu().numpy()) for b in bufs]

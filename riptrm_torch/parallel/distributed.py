"""Process groups and sweep sharding across processes.

Counterpart of ``riptrm_tpu/parallel/distributed.py``: ``initialize``
wires ``torch.distributed`` (the JAX module wires ``jax.distributed``), and
``host_shard`` splits sweep jobs (instance x initial point x solver)
across the processes of a run.  ``rank``, ``world_size`` and ``barrier``
read an initialised group, else act as the only process.  The collectives
over a mesh axis, and those that problems call inside ``torch.func``
transforms, are ``ops/collectives.py``'s.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (default: the world), 0 without a
    process group."""
    return dist.get_rank(group) if _grouped() else 0


def world_size(group=None) -> int:
    """The number of ranks in ``group`` (default: the world), 1 without a
    process group."""
    return dist.get_world_size(group) if _grouped() else 1


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; nothing to wait for without a
    process group."""
    if _grouped():
        dist.barrier(group)


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> torch.device:
    """Join the process group of a multi-process run; returns the device
    this rank computes on.

    A no-op for a single process (``world_size`` None, or 1 with no
    ``init_method``), as the JAX function.  ``init_method`` is
    ``torch.distributed``'s: ``tcp://localhost:<port>`` or ``file://<path>``
    (a path no other run uses).  The backend follows the device: NCCL on
    CUDA (the default device), gloo with ``device='cpu'``; ``backend``
    overrides it.  Rank r computes on CUDA device r mod the host's device
    count (``LOCAL_WORLD_SIZE`` ranks a host, default all of them).  NCCL
    refuses two ranks on one device, so a run with more ranks on the host
    than devices raises here and names ``backend='gloo'``, under which
    ranks may share a card."""
    dev_type = "cuda" if device is None else torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if world_size is None or (world_size <= 1 and init_method is None):
        return _rank_device(dev_type, 0)
    if rank is None:
        raise ValueError("initialize: a multi-process run needs this process's rank")
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if 0 < cards < local_ranks:  # no card at all: _rank_device says so
            raise ValueError(
                f"initialize: {local_ranks} ranks on this host and {cards} CUDA device(s): "
                "NCCL refuses two ranks on one device; pass backend='gloo' to share a card")
    device = _rank_device(dev_type, rank % local_ranks)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}  # NCCL's rank-to-card map
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return device


def _rank_device(dev_type: str, local_rank: int) -> torch.device:
    if dev_type != "cuda":
        return torch.device(dev_type)
    from riptrm_torch.utils.devices import cuda_device

    cuda_device()  # raises without CUDA
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def host_shard(items: Sequence, process_id: Optional[int] = None, num: Optional[int] = None):
    """Deterministic round-robin split of sweep jobs across host processes
    (by default this process's rank among the world's, or the only one)."""
    pid = rank() if process_id is None else process_id
    n = world_size() if num is None else num
    return [item for i, item in enumerate(items) if i % n == pid]

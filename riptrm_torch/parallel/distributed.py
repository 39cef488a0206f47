"""Sweep sharding across host processes.

Counterpart of ``riptrm_tpu/parallel/distributed.py``'s ``host_shard``: the
reference scales out by Hydra multirun forking OS processes, and
``host_shard`` splits sweep jobs (instance x initial point x solver)
across the processes of a run.  The process index and count come from an
initialised ``torch.distributed`` group, else 0 of 1.  Initialising the
group (the JAX module's ``initialize``) waits for ROADMAP.md queue 1
item 5 (scale-out).
"""

from __future__ import annotations

from typing import Optional, Sequence


def host_shard(items: Sequence, process_id: Optional[int] = None, num: Optional[int] = None):
    """Deterministic round-robin split of sweep jobs across host processes
    (by default this process's rank among the ``torch.distributed`` group's,
    or the only one)."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    pid = (dist.get_rank() if grouped else 0) if process_id is None else process_id
    n = (dist.get_world_size() if grouped else 1) if num is None else num
    return [item for i, item in enumerate(items) if i % n == pid]

"""The collectives of the port's scale-out: over the axis of a
``torch.distributed`` device mesh, and inside ``torch.func`` transforms.

A leaf module: it imports nothing of the package, so that problems and
ops may call it without the sweep layer above them.

A problem whose data is split across ranks (StableIdentification's
trajectory columns, NonnegPCA's Zs rows) evaluates its cost as the sum of
per-rank partial costs of a replicated point.  ``enter`` and ``exit_sum``
are the two halves of that pattern (Megatron's f and g):

* ``enter(x)`` on the replicated point: identity forward, ``all_reduce``
  of the gradient backward (each rank's partial gradient is summed);
* ``exit_sum(p)`` on a rank's partial cost: ``all_reduce`` forward,
  identity backward (the replicated cotangent reaches each partial as is).

Each one's backward is the other, and each has explicit ``vmap`` and
``jvp`` rules, so ``torch.func``'s ``vmap``, ``grad``, ``jvp`` and ``vjp``
compose with them to any depth (the Hessian-vector products of
``problems/problem.py`` differentiate the gradient's own collective).
Under ``vmap`` a collective acts once on the whole lane-leading physical
tensor.  The collectives sit inside the cost: the Lagrangian's constraint
term stays replicated, and reducing its gradient would count it once a
rank.  Every rank must evaluate the same functions in the same order,
which holds where ranks hold the same lanes (the ranks of one tp group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def mesh_axis(mesh, axis: str):
    """(group, size, index) of ``mesh``'s axis ``axis``: the process group
    of this rank's ranks along it, their count and this rank's place."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no axis {axis!r}")
    return mesh.get_group(axis), mesh.shape[names.index(axis)], mesh.get_local_rank(axis)


def shard_range(count: int, size: int, index: int, what: str):
    """The slice of ``count`` items that place ``index`` of ``size`` holds;
    ``count`` must be divisible by ``size`` (``what`` names both in the
    refusal)."""
    if count % size:
        raise ValueError(f"{what}: {count} is not divisible by the axis size {size}")
    per = count // size
    return slice(index * per, (index + 1) * per)


# ----------------------------------------------------------------------
# Collectives on plain tensors
# ----------------------------------------------------------------------
def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``); every rank's ``t`` has one shape.
    Booleans travel as bytes (gloo has no boolean type)."""
    if t.dtype == torch.bool:
        return all_gather_cat(t.to(torch.uint8), group, dim).to(torch.bool)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, on every rank (out of place)."""
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


# ----------------------------------------------------------------------
# The collectives of a sharded cost, under torch.func
# ----------------------------------------------------------------------
class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Exit.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return _Enter.apply(x_t, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Enter.apply(x, group), in_dims[0]


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(p, group):
        return all_sum(p, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Enter.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, p_t, _):
        return _Exit.apply(p_t, ctx.group)

    @staticmethod
    def vmap(info, in_dims, p, group):
        return _Exit.apply(p, group), in_dims[0]


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated on every rank of ``group``, as the input of a
    rank's partial computation: identity, whose gradient is summed over
    the ranks."""
    return _Enter.apply(x, group)


def exit_sum(p: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``group`` of each rank's partial value
    ``p``, replicated: ``all_reduce``, whose gradient reaches each partial
    unchanged."""
    return _Exit.apply(p, group)

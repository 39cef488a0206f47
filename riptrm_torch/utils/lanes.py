"""Per-lane helpers over a leading lane axis: values [B, ...], per-lane
scalars and masks [B]."""

from __future__ import annotations

import torch


def dot(u, v):
    """Inner product over the last axis, per lane: [B, n] x [B, n] -> [B]."""
    return torch.sum(u * v, dim=-1)


def mv(a, v):
    """Matrix-vector product per lane: [B, m, n] x [B, n] -> [B, m]."""
    return torch.einsum("bij,bj->bi", a, v)


def sym_mv(a, v):
    """A v per lane for a symmetric ``a`` shared by the lanes [n, n] or
    given per lane [B, n, n] (a structure's Zs under instance batching);
    ``v`` [B, n]."""
    return mv(a, v) if a.ndim == 3 else v @ a


def bcast(a, like):
    """A per-lane scalar or mask [B] shaped to broadcast against ``like``
    [B, ...]."""
    return a.reshape(a.shape + (1,) * (like.ndim - 1))


def where_lanes(mask, a, b):
    """``torch.where`` with a [B] mask over [B, ...] values."""
    return torch.where(bcast(mask, a), a, b)

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


def bcast(a, like):
    """A per-lane scalar or mask [B] shaped to broadcast against ``like``
    [B, ...]."""
    return a.reshape(a.shape + (1,) * (like.ndim - 1))


def where_lanes(mask, a, b):
    """``torch.where`` with a [B] mask over [B, ...] values."""
    return torch.where(bcast(mask, a), a, b)

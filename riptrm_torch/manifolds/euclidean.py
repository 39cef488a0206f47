"""Euclidean space R^shape, over a leading lane axis.

Counterpart of ``riptrm_tpu/manifolds/euclidean.py::Euclidean`` (its
symmetric and skew-symmetric subspaces wait for StableIdentification,
ROADMAP.md queue 1 item 5): the Frobenius metric, the retraction x + v and
the identity basis.  Points and tangents are ``[B, *shape]``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import Manifold


@dataclasses.dataclass(frozen=True)
class Euclidean(Manifold):
    shape: tuple  # e.g. (m,) or (d, d)

    def __init__(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], tuple):
            shape = shape[0]
        object.__setattr__(self, "shape", tuple(int(s) for s in shape))

    @property
    def dim(self) -> int:
        return math.prod(self.shape)

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.dim)

    def _flat(self, u):
        return u.reshape(u.shape[: u.ndim - len(self.shape)] + (-1,))

    def inner(self, x, u, v):
        return torch.sum(self._flat(u) * self._flat(v), dim=-1)

    def proj(self, x, v):
        return v

    def retract(self, x, v):
        return x + v

    def dist(self, x, y):
        return torch.linalg.vector_norm(self._flat(x - y), dim=-1)

    def ehess2rhess(self, x, egrad, ehess, v):
        return ehess

    def basis(self, x):
        """The identity basis, [B, dim, *shape]."""
        eye = torch.eye(self.dim, dtype=x.dtype, device=x.device)
        return eye.reshape((1, self.dim) + self.shape).expand((x.shape[0], self.dim) + self.shape)

    def to_coords(self, x, basis, u):
        return torch.einsum("bkn,bn->bk", self._flat(basis), self._flat(u))

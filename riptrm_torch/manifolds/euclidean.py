"""Euclidean spaces and their matrix subspaces, over a leading lane axis.

Counterpart of ``riptrm_tpu/manifolds/euclidean.py``: ``Euclidean`` (the
dual and slack spaces), ``SkewSymmetric`` (StableIdentification's J block)
and ``Symmetric``.  All three are flat subspaces of a Euclidean ambient
space: the Frobenius metric and the retraction x + v, with only the
subspace projection and the orthonormal basis differing (``_FlatSpace``).
Points and tangents are ``[B, *shape]``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import (
    Manifold,
    _skew_basis,
    _sym_basis,
    randn_on,
    skew,
    skew_coords,
    sym,
    sym_coords,
)


class _FlatSpace(Manifold):
    """Flat subspace of R^shape: subclasses define ``shape``, ``dim``,
    ``_sub`` (the linear projection onto the subspace) and ``basis``."""

    @staticmethod
    def _sub(v):
        raise NotImplementedError

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.dim)

    def _flat(self, u):
        return u.reshape(u.shape[: u.ndim - len(self.shape)] + (-1,))

    def inner(self, x, u, v):
        return torch.sum(self._flat(u) * self._flat(v), dim=-1)

    def proj(self, x, v):
        return self._sub(v)

    def retract(self, x, v):
        return x + v

    def dist(self, x, y):
        return torch.linalg.vector_norm(self._flat(x - y), dim=-1)

    def egrad2rgrad(self, x, egrad):
        return self._sub(egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        return self._sub(ehess)

    def random_point(self, generator, lanes=1, *, dtype=None, device=None):
        return self._sub(randn_on(generator, (lanes,) + self.shape, dtype, device))

    def random_tangent(self, x, generator):
        v = self._sub(torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                  device=x.device))
        return v / self.norm(x, v).reshape((-1,) + (1,) * len(self.shape))


@dataclasses.dataclass(frozen=True)
class Euclidean(_FlatSpace):
    shape: tuple  # e.g. (m,) or (d, d)

    def __init__(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], tuple):
            shape = shape[0]
        object.__setattr__(self, "shape", tuple(int(s) for s in shape))

    @property
    def dim(self) -> int:
        return math.prod(self.shape)

    @staticmethod
    def _sub(v):
        return v

    def basis(self, x):
        """The identity basis, [B, dim, *shape]."""
        eye = torch.eye(self.dim, dtype=x.dtype, device=x.device)
        return eye.reshape((1, self.dim) + self.shape).expand((x.shape[0], self.dim) + self.shape)


@dataclasses.dataclass(frozen=True)
class SkewSymmetric(_FlatSpace):
    """Skew-symmetric d x d matrices with the Frobenius metric."""

    d: int

    @property
    def shape(self) -> tuple:
        return (self.d, self.d)

    @property
    def dim(self) -> int:
        return self.d * (self.d - 1) // 2

    @staticmethod
    def _sub(v):
        return skew(v)

    def basis(self, x):
        """(E_ij - E_ji)/sqrt(2), i < j, row-major: [B, dim, d, d]."""
        b = _skew_basis(self.d, dtype=x.dtype, device=x.device)
        return b.expand((x.shape[0],) + b.shape)

    def coords_of_stack(self, x, basis, us):
        return skew_coords(us)


@dataclasses.dataclass(frozen=True)
class Symmetric(_FlatSpace):
    """Symmetric d x d matrices with the Frobenius metric."""

    d: int

    @property
    def shape(self) -> tuple:
        return (self.d, self.d)

    @property
    def dim(self) -> int:
        return self.d * (self.d + 1) // 2

    @staticmethod
    def _sub(v):
        return sym(v)

    def basis(self, x):
        """E_ii, then (E_ij + E_ji)/sqrt(2), i < j: [B, dim, d, d]."""
        b = _sym_basis(self.d, dtype=x.dtype, device=x.device)
        return b.expand((x.shape[0],) + b.shape)

    def coords_of_stack(self, x, basis, us):
        return sym_coords(us)

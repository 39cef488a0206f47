"""Unit sphere S^{n-1} embedded in R^n, over a leading lane axis.

Counterpart of ``riptrm_tpu/manifolds/sphere.py``, with its Householder
tangent basis.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import Manifold, randn_on


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


@dataclasses.dataclass(frozen=True)
class Sphere(Manifold):
    n: int  # ambient dimension; manifold is S^{n-1}

    @property
    def dim(self) -> int:
        return self.n - 1

    @property
    def typical_dist(self) -> float:
        return math.pi

    @property
    def point_shape(self) -> tuple:
        return (self.n,)

    def inner(self, x, u, v):
        return _dot(u, v)

    def proj(self, x, v):
        return v - _dot(x, v)[..., None] * x

    def retract(self, x, v):
        y = x + v
        return y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)

    def dist(self, x, y):
        return torch.arccos(torch.clamp(_dot(x, y), -1.0, 1.0))

    def egrad2rgrad(self, x, egrad):
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        return self.proj(x, ehess) - _dot(x, egrad)[..., None] * v

    def random_point(self, generator, lanes=1, *, dtype=None, device=None):
        v = randn_on(generator, (lanes, self.n), dtype, device)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def random_tangent(self, x, generator):
        v = self.proj(
            x, torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        )
        return v / self.norm(x, v)[..., None]

    def basis(self, x):
        """Rows 0..n-2 of the Householder reflector H = I - beta w w',
        w = x + sign(x_n) e_n, per lane: an orthonormal basis of x^perp
        (H is symmetric and orthogonal, and its last row is -sign(x_n) x).
        [B, n-1, n]."""
        n = self.n
        s = torch.where(x[:, n - 1] >= 0, 1.0, -1.0).to(x.dtype)
        w = x.clone()
        w[:, n - 1] += s
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        h = eye - (2.0 / _dot(w, w))[:, None, None] * (w[:, :, None] * w[:, None, :])
        return h[:, :, : n - 1].mT

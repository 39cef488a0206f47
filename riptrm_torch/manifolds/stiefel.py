"""Stiefel manifold St(n, p) of n x p matrices with orthonormal columns,
over a leading lane axis (points and tangents ``[B, n, p]``).

Counterpart of ``riptrm_tpu/manifolds/stiefel.py``: the embedded geometry
with tangent space {V : X'V + V'X = 0}, the polar retraction and the
chordal distance.  The closed-form tangent ``basis`` waits for exact mode
(ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import Manifold, randn_on, sym


def _frob(u, v):
    return torch.sum(u * v, dim=(-2, -1))


@dataclasses.dataclass(frozen=True)
class Stiefel(Manifold):
    n: int
    p: int

    @property
    def dim(self) -> int:
        return self.n * self.p - self.p * (self.p + 1) // 2

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.p)

    def inner(self, x, u, v):
        return _frob(u, v)

    def proj(self, x, v):
        return v - x @ sym(x.mT @ v)

    def retract(self, x, v):
        # polar retraction: the orthonormal factor of x + v (a library SVD,
        # as the JAX package computes it outside any kernel).  On CUDA the
        # bidiagonalising gesvd driver, not the default Jacobi gesvdj: in
        # float32 at St(128, 8) gesvdj's factor is twice as far from
        # orthonormal, and that noise keeps most BoundedPCA lanes from ever
        # meeting their first inner stopping test.
        driver = "gesvd" if x.is_cuda else None
        u, _, vh = torch.linalg.svd(x + v, full_matrices=False, driver=driver)
        return u @ vh

    def dist(self, x, y):
        # chordal distance, the JAX package's logging metric
        return torch.linalg.vector_norm(x - y, dim=(-2, -1))

    def egrad2rgrad(self, x, egrad):
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        # The outer projection is part of the embedded Weingarten form:
        # without it the result carries a normal component x sym(x'v
        # sym(x'g)) that the tCG would accumulate in its residual.
        return self.proj(x, ehess - v @ sym(x.mT @ egrad))

    def random_point(self, generator, lanes=1, *, dtype=None, device=None):
        a = randn_on(generator, (lanes, self.n, self.p), dtype, device)
        q, _ = torch.linalg.qr(a)
        return q

    def random_tangent(self, x, generator):
        v = self.proj(
            x, torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        )
        return v / self.norm(x, v)[..., None, None]

"""Stiefel manifold St(n, p) of n x p matrices with orthonormal columns,
over a leading lane axis (points and tangents ``[B, n, p]``).

Counterpart of ``riptrm_tpu/manifolds/stiefel.py``: the embedded geometry
with tangent space {V : X'V + V'X = 0}, the polar retraction and the
chordal distance, and the closed-form tangent ``basis``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import (
    Manifold,
    _skew_basis,
    orthonormal_completion,
    randn_on,
    sym,
)


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

    @property
    def point_shape(self) -> tuple:
        return (self.n, self.p)

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

    def basis(self, x):
        """Frobenius-orthonormal tangent basis per lane: X A_k for the
        skew basis A_k, then X_perp E_ij for the unit matrices E_ij of
        [n-p, p] (row-major).  [B, dim, n, p].  X_perp comes from a complete
        QR (``orthonormal_completion``), whose column signs LAPACK and
        cuSOLVER choose: the basis, and coordinates in it, may differ from
        the JAX package's by those signs; spectra and ambient vectors do
        not."""
        b, n, p = x.shape
        xp = orthonormal_completion(x)  # [B, n, n-p]
        sk = _skew_basis(p, dtype=x.dtype, device=x.device)
        part1 = torch.einsum("bij,kjl->bkil", x, sk)
        eye = torch.eye(p, dtype=x.dtype, device=x.device)
        part2 = torch.einsum("bik,jl->bkjil", xp, eye).reshape(b, (n - p) * p, n, p)
        return torch.cat([part1, part2], dim=1)

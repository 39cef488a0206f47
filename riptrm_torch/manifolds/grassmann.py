"""Grassmann manifold Gr(n, p) of p-dimensional subspaces of R^n, over a
leading lane axis (points and tangents ``[B, n, p]``).

Counterpart of ``riptrm_tpu/manifolds/grassmann.py``: points are n x p
orthonormal frames, tangents n x p matrices in the horizontal space
(X'V = 0); the polar retraction, the principal-angle distance and the
closed-form tangent basis X_perp[:, k] e_j' from one complete QR.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import Manifold, orthonormal_completion, randn_on


def _frob(u, v):
    return torch.sum(u * v, dim=(-2, -1))


@dataclasses.dataclass(frozen=True)
class Grassmann(Manifold):
    n: int
    p: int

    @property
    def dim(self) -> int:
        return self.p * (self.n - self.p)

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.p)

    @property
    def point_shape(self) -> tuple:
        return (self.n, self.p)

    def inner(self, x, u, v):
        return _frob(u, v)

    def proj(self, x, v):
        return v - x @ (x.mT @ v)

    def retract(self, x, v):
        # polar retraction, the orthonormal factor of x + v; on CUDA the
        # gesvd driver, as Stiefel.retract (the default Jacobi driver's
        # float32 factor is noisier)
        driver = "gesvd" if x.is_cuda else None
        u, _, vh = torch.linalg.svd(x + v, full_matrices=False, driver=driver)
        return u @ vh

    def dist(self, x, y):
        s = torch.clamp(torch.linalg.svdvals(x.mT @ y), -1.0, 1.0)
        return torch.linalg.vector_norm(torch.arccos(s), dim=-1)

    def egrad2rgrad(self, x, egrad):
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        return self.proj(x, ehess) - v @ (x.mT @ egrad)

    def random_point(self, generator, lanes=1, *, dtype=None, device=None):
        q, _ = torch.linalg.qr(randn_on(generator, (lanes, self.n, self.p), dtype, device))
        return q

    def random_tangent(self, x, generator):
        v = self.proj(
            x, torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        )
        return v / self.norm(x, v)[..., None, None]

    def basis(self, x):
        """X_perp[:, k] e_j' for k < n-p, j < p (k-major): [B, dim, n, p].
        X_perp comes from a complete QR (``orthonormal_completion``), whose
        column signs may differ from the JAX package's."""
        b, n, p = x.shape
        xp = orthonormal_completion(x)  # [B, n, n-p]
        eye = torch.eye(p, dtype=x.dtype, device=x.device)
        return torch.einsum("bik,jl->bkjil", xp, eye).reshape(b, (n - p) * p, n, p)

    def coords_of_stack(self, x, basis, us):
        """Coordinates [B, K, dim] of us [B, K, n, p]: X_perp' U for each,
        k-major, as one batched product over n with X_perp, the first
        column of every p-th basis vector (no sum over the basis's zeros)."""
        b, k, n, p = us.shape
        xp = basis[:, ::p, :, 0]  # [B, n-p, n]
        c = torch.bmm(xp, us.permute(0, 2, 1, 3).reshape(b, n, k * p))
        return c.reshape(b, n - p, k, p).permute(0, 2, 1, 3).reshape(b, k, (n - p) * p)

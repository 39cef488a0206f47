"""Manifold protocol over a leading lane axis.

Counterpart of ``riptrm_tpu/manifolds/base.py``.  Points and tangent
vectors are tensors ``[B, ...]`` whose first axis is the lane (one
independent solve per lane); every scalar-valued operation returns ``[B]``.
The JAX package gets its lanes from ``vmap``; here they are written out,
so one step function serves the host runner (B = 1) and the batched sweep.

Each manifold has a deterministic, closed-form tangent basis ``basis(x)``,
metric-orthonormal at x: ``[B, dim, ...]``, slice ``[:, k]`` the k-th basis
vector of every lane.  ``to_coords``/``from_coords`` move between tangent
vectors and coordinates ``[B, dim]``; exact mode does its dense algebra
(TRS, eigendecompositions) in those coordinates, where the Gram matrix is
the identity.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from riptrm_torch.config import resolve


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Abstract base; subclasses are frozen dataclasses of static shapes."""

    @property
    def dim(self) -> int:  # intrinsic dimension
        raise NotImplementedError

    @property
    def typical_dist(self) -> float:
        raise NotImplementedError

    def inner(self, x, u, v) -> torch.Tensor:
        """Metric inner product per lane: [B]."""
        raise NotImplementedError

    def norm(self, x, u) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.inner(x, u, u), min=0.0))

    def proj(self, x, v):
        """Orthogonal projection of an ambient vector onto T_x M."""
        raise NotImplementedError

    def retract(self, x, v):
        raise NotImplementedError

    def dist(self, x, y) -> torch.Tensor:
        raise NotImplementedError

    def zero_vector(self, x):
        return torch.zeros_like(x)

    def egrad2rgrad(self, x, egrad):
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        raise NotImplementedError

    def proj_tangent(self, x, t):
        """Re-project a drifted tangent-typed value back onto T_x M."""
        return self.proj(x, t)

    def transport(self, x, y, v):
        """Projection transport of v from T_x to T_y."""
        return self.proj(y, v)

    def random_point(self, generator: torch.Generator, lanes: int = 1, *,
                     dtype=None, device=None):
        raise NotImplementedError

    def random_tangent(self, x, generator: torch.Generator):
        raise NotImplementedError

    def basis(self, x):
        """Stacked metric-orthonormal tangent basis at x: [B, dim, ...]."""
        raise NotImplementedError

    def from_coords(self, x, basis, c):
        """sum_k c[:, k] basis[:, k]: coordinates [B, dim] -> tangents."""
        b = basis.reshape(basis.shape[0], basis.shape[1], -1)
        return torch.bmm(c[:, None, :], b).reshape(basis.shape[:1] + basis.shape[2:])

    def to_coords(self, x, basis, u):
        """Metric inner products of u against every basis vector: [B, dim]."""
        return self.inner(x[:, None], basis, u[:, None])

    def flat_dim(self, x) -> int:
        """Number of ambient scalars in one lane's point or tangent."""
        return x[0].numel()


def randn_on(generator, shape, dtype=None, device=None):
    """Standard normal draws of ``shape`` from ``generator``, on ``device``
    (default: the card, ``config.resolve``).  The draw is made on the
    generator's own device and then moved, since a CPU generator cannot
    feed a CUDA draw."""
    dtype, device = resolve(dtype, device)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def sym(a):
    """Symmetric part over the last two axes, e.g. of lane-batched [B, p, p]."""
    return 0.5 * (a + a.mT)


def skew(a):
    """Skew-symmetric part over the last two axes."""
    return 0.5 * (a - a.mT)


def _sym_basis(d: int, dtype=None, device=None):
    """Frobenius-orthonormal basis of d x d symmetric matrices, stacked
    [d(d+1)/2, d, d]: E_ii, then (E_ij + E_ji)/sqrt(2) for i < j, row-major."""
    out = np.zeros((d * (d + 1) // 2, d, d))
    k = 0
    for i in range(d):
        out[k, i, i] = 1.0
        k += 1
    for i in range(d):
        for j in range(i + 1, d):
            out[k, i, j] = out[k, j, i] = 1.0 / np.sqrt(2.0)
            k += 1
    dtype, device = resolve(dtype, device)
    return torch.tensor(out, dtype=dtype, device=device)


def _skew_basis(d: int, dtype=None, device=None):
    """Frobenius-orthonormal basis of d x d skew-symmetric matrices, stacked
    [d(d-1)/2, d, d]: (E_ij - E_ji)/sqrt(2) for i < j, row-major."""
    out = np.zeros((d * (d - 1) // 2, d, d))
    k = 0
    for i in range(d):
        for j in range(i + 1, d):
            out[k, i, j] = 1.0 / np.sqrt(2.0)
            out[k, j, i] = -1.0 / np.sqrt(2.0)
            k += 1
    dtype, device = resolve(dtype, device)
    return torch.tensor(out, dtype=dtype, device=device)


def orthonormal_completion(x):
    """X_perp [B, n, n-p]: an orthonormal completion of the frames x
    [B, n, p], by a complete QR.  LAPACK and cuSOLVER may pick other column
    signs than the JAX package's QR, so the completion (and every basis
    built on it) can differ from JAX's by the sign of a column."""
    q, _ = torch.linalg.qr(x, mode="complete")
    return q[..., x.shape[-1]:]

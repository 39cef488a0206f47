"""Symmetric positive definite matrices with the affine-invariant metric,
over a leading lane axis (points and tangents ``[B, d, d]``).

Counterpart of ``riptrm_tpu/manifolds/spd.py``: the metric
tr(P^-1 U P^-1 V), the second-order retraction P + V + V P^-1 V / 2, the
log-eigenvalue distance, and the metric-orthonormal basis L S_k L' with
L = chol(P) and {S_k} the Frobenius-orthonormal symmetric basis, whose
coordinates take two triangular solves (``coords_of_stack``).

``jnp.linalg.cholesky`` returns NaN on a matrix that is not positive
definite, where ``torch.linalg.cholesky`` raises; ``_chol`` keeps the JAX
behaviour per lane (``cholesky_ex``, NaN on the lanes it fails on), so a
float32 trial point that rounds out of the cone stops its own lane and
not the sweep, with no host synchronisation.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import (
    Manifold,
    Recent,
    _sym_basis,
    bmm,
    randn_on,
    sym,
    sym_coords,
)


def _chol(x):
    """Lower Cholesky factor of x [..., d, d], NaN where x is not positive
    definite."""
    l, info = torch.linalg.cholesky_ex(x)
    return torch.where((info != 0)[..., None, None], math.nan, l)


def _cho_solve(l, u):
    """x^-1 u from x's Cholesky factor ``l``: the two triangular solves of
    LAPACK's potrs, as ``jax.scipy.linalg.cho_solve``.  float32 systems of
    one shape within ``spd_solve_plan``'s width take them in one launch
    (``ops/kernels.py::spd_cho_solve``, K9; its plain version on the CPU);
    every other solve takes the library's two.  Not
    ``torch.cholesky_solve``: on CUDA that runs MAGMA's batched solve,
    which waits on the host (``cudaStreamSynchronize``) and takes ~2 ms a
    call at 131072 lanes of 5 x 5."""
    # imported here: ops imports the manifolds (ops/kernels.py)
    from riptrm_torch.ops import kernels

    if (l.dtype == u.dtype == torch.float32 and l.shape == u.shape
            and kernels.spd_solve_plan(l.shape[-1]) is not None):
        return kernels.spd_cho_solve(l, u)
    a = torch.linalg.solve_triangular(l, u, upper=False)
    return torch.linalg.solve_triangular(l.transpose(-2, -1), a, upper=True)


def _congruence_inv(l, u):
    """L^-1 u L^-T for a symmetric u: two triangular solves."""
    a = torch.linalg.solve_triangular(l, u, upper=False)
    return torch.linalg.solve_triangular(l, a.mT, upper=False)


@dataclasses.dataclass(frozen=True)
class SymmetricPositiveDefinite(Manifold):
    d: int
    # every operator takes any leading axes ([B, k, d, d]: ``Product``)
    stacks = True

    @property
    def dim(self) -> int:
        return self.d * (self.d + 1) // 2

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.dim)

    @property
    def point_shape(self) -> tuple:
        return (self.d, self.d)

    def inner(self, x, u, v):
        return self.inner_at(x)(u, v)

    def inner_at(self, x):
        """tr(x^-1 u x^-1 v) with x's Cholesky factor computed once (the tCG
        takes four inner products an iteration at one point), and the
        solves of the last few tangents kept (its gradient's in every
        iteration, its candidate step's in two products)."""
        l = _chol(x)
        solved = Recent()

        def inner(u, v):
            iu = solved.get(u, lambda: _cho_solve(l, u))
            iv = iu if v is u else solved.get(v, lambda: _cho_solve(l, v))
            return torch.sum(iu * iv.transpose(-2, -1), dim=(-2, -1))

        return inner

    def norm(self, x, u):
        return torch.linalg.matrix_norm(_congruence_inv(_chol(x), u))

    def proj(self, x, v):
        return sym(v)

    def retract(self, x, v):
        # the second-order retraction (pymanopt's)
        return sym(x + v + 0.5 * v @ _cho_solve(_chol(x), v))

    def dist(self, x, y):
        # imported here: ops imports the manifolds (ops/kernels.py)
        from riptrm_torch.ops.spectrum import eigvalsh_nan

        w = eigvalsh_nan(sym(_congruence_inv(_chol(x), y)))
        return torch.linalg.vector_norm(
            torch.log(torch.clamp(w, min=torch.finfo(w.dtype).tiny)), dim=-1)

    def egrad2rgrad(self, x, egrad):
        return bmm(bmm(x, sym(egrad)), x)

    def ehess2rhess(self, x, egrad, ehess, v):
        # pymanopt: P sym(ehess) P + sym(V sym(egrad) P)
        return bmm(bmm(x, sym(ehess)), x) + sym(bmm(bmm(v, sym(egrad)), x))

    def random_point(self, generator, lanes=1, *, dtype=None, device=None):
        """A random orthogonal conjugation of eigenvalues in [1, 2]."""
        q, _ = torch.linalg.qr(randn_on(generator, (lanes, self.d, self.d), dtype, device))
        u = torch.rand((lanes, self.d), generator=generator, dtype=q.dtype,
                       device=generator.device).to(q.device)
        return sym((q * (1.0 + u)[:, None, :]) @ q.mT)

    def random_tangent(self, x, generator):
        c = torch.randn((x.shape[0], self.dim), generator=generator, dtype=x.dtype,
                        device=x.device)
        c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
        return self.from_coords(x, self.basis(x), c)

    def basis(self, x):
        """L S_k L' per lane, [B, dim, d, d]."""
        l = _chol(x)
        s = _sym_basis(self.d, dtype=x.dtype, device=x.device)
        return torch.einsum("bij,kjl,bml->bkim", l, s, l)

    def coords_of_stack(self, x, basis, us):
        """c_k = tr(x^-1 (L S_k L') x^-1 u) = <S_k, L^-1 u L^-T>_F for each
        of the stacked u: two triangular solves, not ``dim`` metric inner
        products."""
        return sym_coords(_congruence_inv(_chol(x)[:, None], us))

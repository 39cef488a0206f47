"""Manifold protocol over a leading lane axis.

Counterpart of ``riptrm_tpu/manifolds/base.py``.  Points and tangent
vectors are tensors ``[B, ...]`` whose first axis is the lane (one
independent solve per lane); every scalar-valued operation returns ``[B]``.
The JAX package gets its lanes from ``vmap``; here they are written out,
so one step function serves the host runner (B = 1) and the batched sweep.

Each manifold has a deterministic, closed-form tangent basis ``basis(x)``,
metric-orthonormal at x: ``[B, dim, ...]``, slice ``[:, k]`` the k-th basis
vector of every lane.  ``to_coords``/``from_coords`` move between tangent
vectors and coordinates ``[B, dim]``, ``coords_of_stack`` takes the
coordinates of K stacked tangents a lane in one contraction; exact mode
does its dense algebra (TRS, eigendecompositions) in those coordinates,
where the Gram matrix is the identity.  ``map_basis`` applies a function
to every basis vector, so a manifold whose basis is not one tensor
(``Product``: one per component) is materialised without a
block-diagonal basis.

Structured points (the JAX package's pytrees: a ``Product``'s tuple, a
fixed-rank ``(U, S, V)``) are one packed tensor per lane here, so every
solver state stays a tensor with a leading lane axis.  ``pack``/``unpack``
move between the components and the packed tensor (points),
``pack_tangent``/``unpack_tangent`` likewise for tangents; on a manifold
with one component they are the identity.  ``point_shape`` and
``tangent_shape`` are one lane's packed shapes.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch.func import vmap

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

    def inner_at(self, x):
        """(u, v) -> ``inner(x, u, v)`` with the point's own work done once
        (a metric that factors x, as SPD's, factors it here): for loops that
        take many inner products at one point (tCG, CR, Lanczos)."""
        return lambda u, v: self.inner(x, u, v)

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
        """sum_k c[..., k] basis[:, k]: coordinates [B, dim] -> tangents, or
        stacked coordinates [B, K, dim] -> K tangents a lane [B, K, ...], in
        one batched product."""
        b = basis.reshape(basis.shape[0], basis.shape[1], -1)
        out = torch.bmm(c.reshape(c.shape[0], -1, c.shape[-1]), b)
        return out.reshape(c.shape[:-1] + basis.shape[2:])

    def to_coords(self, x, basis, u):
        """Metric inner products of u [B, ...] against every basis vector:
        [B, dim]."""
        return self.coords_of_stack(x, basis, u[:, None])[:, 0]

    def coords_of_stack(self, x, basis, us):
        """Coordinates [B, K, dim] of K stacked tangents a lane, us [B, K,
        ...]: one batched product of the flattened tangents with the
        flattened basis, for the embedded (Frobenius) metric; a manifold
        with another metric, or coordinates in closed form, overrides it.
        Dense materialisation takes every coordinate through here, so no
        step broadcasts the basis against each of the K tangents."""
        b = basis.reshape(basis.shape[0], basis.shape[1], -1)
        return torch.bmm(us.reshape(us.shape[0], us.shape[1], -1), b.mT)

    def map_basis(self, basis, fn, out_dims=0):
        """``fn`` applied to every basis vector (lane-batched tangents [B,
        ...]), its results stacked along ``out_dims``: one ``vmap`` over the
        basis axis."""
        return vmap(fn, in_dims=1, out_dims=out_dims)(basis)

    def basis_slice(self, basis, start: int, stop: int):
        """The basis vectors ``start`` to ``stop`` (exclusive) of ``basis``,
        in the form ``map_basis`` takes."""
        return basis[:, start:stop]

    def flat_dim(self, x) -> int:
        """Number of ambient scalars in one lane's point or tangent."""
        return x[0].numel()

    # ---- packed layout -------------------------------------------------
    @property
    def point_shape(self) -> tuple:
        """One lane's point shape."""
        return tuple(self.shape)

    @property
    def tangent_shape(self) -> tuple:
        """One lane's tangent shape."""
        return self.point_shape

    def pack(self, parts):
        """A point from its components: here one tensor (or a 1-tuple of it)."""
        if isinstance(parts, (tuple, list)):
            (parts,) = parts
        return parts

    def unpack(self, x):
        return x

    def pack_tangent(self, parts):
        return self.pack(parts)

    def unpack_tangent(self, t):
        return self.unpack(t)


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
    return 0.5 * (a + a.transpose(-2, -1))


def skew(a):
    """Skew-symmetric part over the last two axes."""
    return 0.5 * (a - a.transpose(-2, -1))


class Recent:
    """The last few values made from tensors, found by the tensor object
    itself (``is``): a point-frozen operator that meets one tangent in
    several calls (a tCG's gradient in every iteration, its candidate step
    in two inner products) makes its value once.  The entries hold their
    tensors, so no id is reused while one is listed; no caller changes a
    tangent in place."""

    def __init__(self, size: int = 8):
        self.size, self.items = size, []

    def get(self, key, make):
        for k, value in self.items:
            if k is key:
                return value
        value = make()
        self.items.append((key, value))
        if len(self.items) > self.size:
            del self.items[0]
        return value


def bmm(a, b):
    """a @ b for two stacks of matrices of one batch shape: the ``bmm``
    that ``matmul`` runs for them, on the same operands, without
    ``matmul``'s broadcasting wrappers (a tCG iteration takes dozens of
    5 x 5 products, and each wrapper is host work).  Other shapes go to
    ``matmul``."""
    if a.ndim < 3 or a.shape[:-2] != b.shape[:-2]:
        return a @ b
    if a.ndim == 3:
        return torch.bmm(a, b)
    out = torch.bmm(a.reshape((-1,) + a.shape[-2:]), b.reshape((-1,) + b.shape[-2:]))
    return out.view(a.shape[:-2] + out.shape[-2:])


@functools.lru_cache(maxsize=32)
def _sym_basis(d: int, dtype=None, device=None):
    """Frobenius-orthonormal basis of d x d symmetric matrices, stacked
    [d(d+1)/2, d, d]: E_ii, then (E_ij + E_ji)/sqrt(2) for i < j, row-major.
    Cached per (d, dtype, device): the caller must not write to it."""
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


@functools.lru_cache(maxsize=32)
def _skew_basis(d: int, dtype=None, device=None):
    """Frobenius-orthonormal basis of d x d skew-symmetric matrices, stacked
    [d(d-1)/2, d, d]: (E_ij - E_ji)/sqrt(2) for i < j, row-major.  Cached
    per (d, dtype, device)."""
    out = np.zeros((d * (d - 1) // 2, d, d))
    k = 0
    for i in range(d):
        for j in range(i + 1, d):
            out[k, i, j] = 1.0 / np.sqrt(2.0)
            out[k, j, i] = -1.0 / np.sqrt(2.0)
            k += 1
    dtype, device = resolve(dtype, device)
    return torch.tensor(out, dtype=dtype, device=device)


def sym_coords(a):
    """Coordinates [..., d(d+1)/2] of a d x d matrix against ``_sym_basis``:
    a_ii, then (a_ij + a_ji)/sqrt(2) for i < j, row-major (gathers, not
    products with the stacked basis)."""
    d = a.shape[-1]
    iu, ju = torch.triu_indices(d, d, offset=1, device=a.device)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    return torch.cat([diag, (a[..., iu, ju] + a[..., ju, iu]) / math.sqrt(2.0)], dim=-1)


def skew_coords(a):
    """Coordinates [..., d(d-1)/2] against ``_skew_basis``:
    (a_ij - a_ji)/sqrt(2) for i < j, row-major."""
    d = a.shape[-1]
    iu, ju = torch.triu_indices(d, d, offset=1, device=a.device)
    return (a[..., iu, ju] - a[..., ju, iu]) / math.sqrt(2.0)


def orthonormal_completion(x):
    """X_perp [B, n, n-p]: an orthonormal completion of the frames x
    [B, n, p], by a complete QR.  LAPACK and cuSOLVER may pick other column
    signs than the JAX package's QR, so the completion (and every basis
    built on it) can differ from JAX's by the sign of a column."""
    q, _ = torch.linalg.qr(x, mode="complete")
    return q[..., x.shape[-1]:]

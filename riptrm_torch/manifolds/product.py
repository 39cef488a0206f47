"""Product manifold over a leading lane axis, its points packed in one
tensor per lane.

Counterpart of ``riptrm_tpu/manifolds/product.py``, whose points and
tangents are tuples of component points and tangents.  Here they are one
tensor, so every solver state stays a tensor with a leading lane axis:

* components of one shape are stacked on an axis after the lane axis,
  [B, K, *shape] (StableIdentification's Product(Skew(d), SPD(d), SPD(d))
  is [B, 3, d, d]);
* components of different shapes are flattened and concatenated, [B, N].

``unpack`` gives the component views (also of one lane, as a problem's
per-lane functions see it), ``pack`` the packed tensor.  Every operation
runs per component, as in JAX.  The coordinates are the concatenation of
the components' coordinates and the basis is the tuple of the components'
bases: no block-diagonal basis is materialised (``map_basis`` maps a
function over each component's basis in turn).  A component's points and
tangents must share one shape (the fixed-rank manifold's do not).

In the stacked layout, equal neighbouring components whose operators take
any leading axes (``stacks``: SPD) run as one call on their [B, k, *shape]
slice in the operators a tCG iteration applies (``inner_at``,
``proj_tangent``, ``egrad2rgrad``, ``ehess2rhess``): StableIdentification's
two SPD blocks share each Cholesky solve and product.  Each lane's values
are those of the per-component calls, summed in the same order.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.func import vmap

from riptrm_torch.manifolds.base import Manifold, Recent


@dataclasses.dataclass(frozen=True)
class Product(Manifold):
    manifolds: tuple

    def __init__(self, manifolds):
        manifolds = tuple(manifolds)
        for m in manifolds:
            if (tuple(m.point_shape) != tuple(m.tangent_shape)
                    or type(m).unpack_tangent is not Manifold.unpack_tangent):
                raise NotImplementedError(
                    f"{type(m).__name__}: a Product component's points and tangents "
                    "must share one shape")
        object.__setattr__(self, "manifolds", manifolds)

    @property
    def dim(self) -> int:
        return sum(m.dim for m in self.manifolds)

    @property
    def typical_dist(self) -> float:
        return math.sqrt(sum(m.typical_dist**2 for m in self.manifolds))

    # ---- packed layout -------------------------------------------------
    @property
    def _stacked(self) -> bool:
        return len({tuple(m.point_shape) for m in self.manifolds}) == 1

    @property
    def point_shape(self) -> tuple:
        if self._stacked:
            return (len(self.manifolds),) + tuple(self.manifolds[0].point_shape)
        return (sum(math.prod(m.point_shape) for m in self.manifolds),)

    def pack(self, parts):
        parts = tuple(parts)
        if len(parts) != len(self.manifolds):
            raise ValueError(f"{len(parts)} components for {len(self.manifolds)} manifolds")
        if self._stacked:
            return torch.stack(parts, dim=-1 - len(self.manifolds[0].point_shape))
        lead = parts[0].shape[: parts[0].ndim - len(self.manifolds[0].point_shape)]
        return torch.cat([p.reshape(lead + (-1,)) for p in parts], dim=-1)

    def unpack(self, x):
        if self._stacked:
            axis = x.ndim - 1 - len(self.manifolds[0].point_shape)
            return tuple(x.select(axis, i) for i in range(len(self.manifolds)))
        lead, out, off = x.shape[:-1], [], 0
        for m in self.manifolds:
            size = math.prod(m.point_shape)
            out.append(x[..., off:off + size].reshape(lead + tuple(m.point_shape)))
            off += size
        return tuple(out)

    def _zip(self, *packed):
        return zip(self.manifolds, *(self.unpack(a) for a in packed), strict=True)

    @property
    def _runs(self):
        """(manifold, first, stop) for each run of equal neighbouring
        components that share a call (a run of one elsewhere), or None
        where no run is longer than one."""
        runs, ms, i = [], self.manifolds, 0
        while i < len(ms):
            j = i + 1
            if self._stacked and getattr(ms[i], "stacks", False):
                while j < len(ms) and ms[j] == ms[i]:
                    j += 1
            runs.append((ms[i], i, j))
            i = j
        return runs if len(runs) < len(ms) else None

    def _axis(self, a):
        return a.ndim - 1 - len(self.manifolds[0].point_shape)

    def _part(self, a, i, j):
        """Components i to j of ``a``: the view of one, a stacked slice of
        several."""
        axis = self._axis(a)
        return a.select(axis, i) if j - i == 1 else a.narrow(axis, i, j - i)

    def _by_runs(self, fn, *packed):
        """``fn(manifold, *parts)`` on each run, packed."""
        axis = self._axis(packed[0])
        outs = []
        for m, i, j in self._runs:
            out = fn(m, *(self._part(a, i, j) for a in packed))
            outs.append(out.unsqueeze(axis) if j - i == 1 else out)
        return torch.cat(outs, dim=axis)

    # ---- geometry, per component ----------------------------------------
    def inner(self, x, u, v):
        return sum(m.inner(xi, ui, vi) for m, xi, ui, vi in self._zip(x, u, v))

    def inner_at(self, x):
        if self._runs is not None:
            return self._inner_at_runs(x)
        parts = [m.inner_at(xi) for m, xi in self._zip(x)]

        def inner(u, v):
            return sum(f(ui, vi) for f, ui, vi in zip(parts, self.unpack(u), self.unpack(v),
                                                       strict=True))

        return inner

    def _inner_at_runs(self, x):
        runs = [(m.inner_at(self._part(x, i, j)), i, j) for m, i, j in self._runs]
        # one set of views a tangent, so a component's ``inner_at`` finds
        # the tangents it has met (``Recent``)
        parts = Recent()

        def split(u):
            return parts.get(u, lambda: [self._part(u, i, j) for _, i, j in runs])

        def inner(u, v):
            total = 0
            us, vs = split(u), split(v)
            for (f, i, j), ui, vi in zip(runs, us, vs):
                val = f(ui, vi)
                if j - i == 1:
                    total = total + val
                else:
                    for k in range(j - i):
                        total = total + val[..., k]
            return total

        return inner

    def proj(self, x, v):
        return self.pack(m.proj(xi, vi) for m, xi, vi in self._zip(x, v))

    def proj_tangent(self, x, t):
        if self._runs is not None:
            return self._by_runs(lambda m, xi, ti: m.proj_tangent(xi, ti), x, t)
        return self.pack(m.proj_tangent(xi, ti) for m, xi, ti in self._zip(x, t))

    def transport(self, x, y, v):
        return self.pack(m.transport(xi, yi, vi) for m, xi, yi, vi in self._zip(x, y, v))

    def retract(self, x, v):
        return self.pack(m.retract(xi, vi) for m, xi, vi in self._zip(x, v))

    def dist(self, x, y):
        return torch.sqrt(sum(m.dist(xi, yi) ** 2 for m, xi, yi in self._zip(x, y)))

    def egrad2rgrad(self, x, egrad):
        if self._runs is not None:
            return self._by_runs(lambda m, xi, gi: m.egrad2rgrad(xi, gi), x, egrad)
        return self.pack(m.egrad2rgrad(xi, gi) for m, xi, gi in self._zip(x, egrad))

    def ehess2rhess(self, x, egrad, ehess, v):
        if self._runs is not None:
            return self._by_runs(lambda m, *a: m.ehess2rhess(*a), x, egrad, ehess, v)
        return self.pack(m.ehess2rhess(xi, gi, hi, vi)
                         for m, xi, gi, hi, vi in self._zip(x, egrad, ehess, v))

    def random_point(self, generator, lanes=1, *, dtype=None, device=None):
        return self.pack(m.random_point(generator, lanes, dtype=dtype, device=device)
                         for m in self.manifolds)

    def random_tangent(self, x, generator):
        v = self.pack(m.random_tangent(xi, generator) for m, xi in self._zip(x))
        return v / self.norm(x, v).reshape((-1,) + (1,) * (v.ndim - 1))

    # ---- coordinates: the concatenation of the components' ----------------
    def basis(self, x):
        """The tuple of the components' bases, each [B, dim_i, ...]."""
        return tuple(m.basis(xi) for m, xi in self._zip(x))

    def from_coords(self, x, basis, c):
        out, off = [], 0
        for m, xi, bi in zip(self.manifolds, self.unpack(x), basis, strict=True):
            out.append(m.from_coords(xi, bi, c[..., off:off + m.dim]))
            off += m.dim
        return self.pack(out)

    def coords_of_stack(self, x, basis, us):
        return torch.cat([m.coords_of_stack(xi, bi, ui) for m, xi, bi, ui in
                          zip(self.manifolds, self.unpack(x), basis, self.unpack(us),
                              strict=True)], dim=-1)

    def map_basis(self, basis, fn, out_dims=0):
        """``fn`` over every basis vector, component by component: the k-th
        component's basis vectors, packed with zeros in the other
        components, in one ``vmap`` each."""
        outs = []
        for k, bk in enumerate(basis):
            if bk.shape[1] == 0:  # a component a ``basis_slice`` left out
                continue
            zeros = [torch.zeros(b.shape[:1] + b.shape[2:], dtype=b.dtype, device=b.device)
                     for b in basis]

            def column(b_j, k=k, zeros=zeros):
                parts = list(zeros)
                parts[k] = b_j
                return fn(self.pack(parts))

            outs.append(vmap(column, in_dims=1, out_dims=out_dims)(bk))
        return torch.cat(outs, dim=out_dims)

    def basis_slice(self, basis, start: int, stop: int):
        """The basis vectors ``start`` to ``stop`` of the concatenated
        coordinates: each component's basis cut to its part of the range
        (none of it: zero vectors, which ``map_basis`` skips)."""
        out, off = [], 0
        for m, bk in zip(self.manifolds, basis, strict=True):
            lo, hi = min(max(start - off, 0), m.dim), min(max(stop - off, 0), m.dim)
            out.append(bk[:, lo:hi])
            off += m.dim
        return tuple(out)

"""Problems on factored embedded manifolds (``FixedRankEmbedded``), over
lanes.

Counterpart of ``riptrm_tpu/problems/embedded.py``.  ``Problem``
differentiates with respect to the point's own representation, which is
right where that representation is the ambient embedding, but a
fixed-rank point is its packed factors (U, S, V) while the manifold's
``egrad2rgrad``/``ehess2rhess`` take derivatives with respect to the
embedded m x n matrix X = (U * S) V'.  ``EmbeddedProblem`` takes the
cost and constraints as per-lane functions of that matrix (``a_cost``,
``a_ineq``, ``a_eq``) and chains every derivative through
``manifold.embed_point``/``embed_tangent``:

    egrad(x)        = d a_cost(X)            an ambient [B, m, n] matrix
    rgrad(x)        = proj_x(egrad)
    lag_rhess(x)[v] = ehess2rhess(x, dL(X), d^2 L(X)[embed_tangent(x, v)], v)
    gx_adj(x)[dx]   = -d a_ineq(X)[embed_tangent(x, dx)]

The value-level functions (``cost_fn``/``ineq_fn``/``eq_fn``) are the
ambient ones composed with ``embed_point``, so every value a solver reads
on the point (ared, merit, augmented Lagrangian) needs no change.  The
matrix-free solver paths run on these problems: RIPTRM's tCG, RIPM's
conjugate residual, RALM (with its augmented Lagrangian's gradient taken
in the ambient space).  Per-lane instance data (``Problem.data``) is the
ambient functions' last argument, as it is the point functions'.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import grad, jvp, vjp, vmap

from riptrm_torch.problems.problem import Problem, scoped


@dataclasses.dataclass(frozen=True)
class EmbeddedProblem(Problem):
    """Constrained problem whose cost and constraints act on the ambient
    embedding of a factored point.  Build it with :func:`ambient_problem`."""

    a_cost: Callable = None  # per lane: ambient matrix -> scalar
    a_ineq: Optional[Callable] = None  # per lane: ambient matrix -> [m]
    a_eq: Optional[Callable] = None

    def _alag(self, xa, y, z, *data):
        val = self.a_cost(xa, *data)
        if self.has_ineq:
            val = val + torch.dot(y, self.a_ineq(xa, *data))
        if self.has_eq:
            val = val + torch.dot(z, self.a_eq(xa, *data))
        return val

    # -- first order -------------------------------------------------------
    @scoped
    def egrad(self, x):
        return self._map(grad(self.a_cost))(self.manifold.embed_point(x))

    def rgrad(self, x):
        return self.manifold.egrad2rgrad(x, self.egrad(x))

    @scoped
    def rhess(self, x, v):
        man = self.manifold
        eg, eh = jvp(self._map(grad(self.a_cost)), (man.embed_point(x),),
                     (man.embed_tangent(x, v),))
        return man.ehess2rhess(x, eg, eh, v)

    # -- Lagrangian --------------------------------------------------------
    @scoped
    def lag_egrad(self, x, y, z=None):
        return self._map(grad(self._alag))(self.manifold.embed_point(x), y, self._z(x, z))

    def lag_rgrad(self, x, y, z=None):
        return self.manifold.egrad2rgrad(x, self.lag_egrad(x, y, z))

    @scoped
    def lag_rhess(self, x, y, v, z=None):
        man = self.manifold
        z = self._z(x, z)
        eg, eh = jvp(lambda xa: self._map(grad(self._alag))(xa, y, z), (man.embed_point(x),),
                     (man.embed_tangent(x, v),))
        return man.ehess2rhess(x, eg, eh, v)

    @scoped
    def lag_rhess_at(self, x, y, z=None):
        """v -> Hess L[v] at (x, y, z), the ambient gradient's pullback frozen
        (the ambient Hessian is symmetric)."""
        man = self.manifold
        z = self._z(x, z)
        eg, pullback = vjp(lambda xa: self._map(grad(self._alag))(xa, y, z),
                           man.embed_point(x))

        def hvp(v):
            (eh,) = pullback(man.embed_tangent(x, v))
            return man.ehess2rhess(x, eg, eh, v)

        return hvp

    # -- constraint Jacobians ----------------------------------------------
    @scoped
    def gx_adj(self, x, dx):
        man = self.manifold
        _, dg = jvp(self._map(self.a_ineq), (man.embed_point(x),),
                    (man.embed_tangent(x, dx),))
        return -dg

    @scoped
    def gx_at(self, x):
        man = self.manifold
        _, pullback = vjp(self._map(self.a_ineq), man.embed_point(x))

        def gx(v):
            (eg,) = pullback(-v)
            return man.egrad2rgrad(x, eg)

        return gx

    @scoped
    def hx_at(self, x):
        man = self.manifold
        _, pullback = vjp(self._map(self.a_eq), man.embed_point(x))

        def hx(v):
            (eg,) = pullback(v)
            return man.egrad2rgrad(x, eg)

        return hx

    @scoped
    def hx_adj(self, x, dx):
        man = self.manifold
        _, dh = jvp(self._map(self.a_eq), (man.embed_point(x),), (man.embed_tangent(x, dx),))
        return dh


def ambient_problem(manifold, cost: Callable, ineq: Optional[Callable] = None,
                    eq: Optional[Callable] = None, **kwargs) -> EmbeddedProblem:
    """An :class:`EmbeddedProblem` from per-lane ambient functions: ``cost``,
    ``ineq`` and ``eq`` take the embedded matrix ``manifold.embed_point(x)``
    of one lane (and its data, where ``kwargs`` has ``data``); ``kwargs``
    are the other ``Problem`` fields."""
    embed = manifold.embed_point
    return EmbeddedProblem(
        manifold=manifold,
        cost_fn=lambda x, *d: cost(embed(x), *d),
        ineq_fn=(lambda x, *d: ineq(embed(x), *d)) if ineq is not None else None,
        eq_fn=(lambda x, *d: eq(embed(x), *d)) if eq is not None else None,
        a_cost=cost,
        a_ineq=ineq,
        a_eq=eq,
        **kwargs,
    )

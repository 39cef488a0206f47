"""Constrained Riemannian problem with stacked constraints, over lanes.

Counterpart of ``riptrm_tpu/problems/problem.py``.  The user supplies
per-lane functions of one point (``cost_fn: point -> scalar``,
``ineq_fn: point -> [m]``, ...), where a point is a vector ``[n]`` on the
sphere, a frame ``[n, p]`` on Stiefel and Grassmann, or a packed tensor on
a ``Product`` or the fixed-rank manifold (``manifold.unpack`` gives its
components); every method here takes
lane-batched points ``[B, ...]`` and maps the per-lane functions with
``torch.func.vmap``.  Constraint values are always flat, ``[B, m]``.  Derivatives come from
``torch.func.grad``/``vjp``/``jvp``.

Per-lane instance data (``data`` [B, ...], instance batching in
``parallel/sweep.py::instance_batched_riptrm``): each per-lane function then
takes its lane's data as its last argument, ``cost_fn(point, data)``, and
every method maps the data together with the point.  The JAX package builds
a problem inside ``vmap`` so that its closed-over data is traced per lane;
here the data is an argument of the mapped functions instead, so one
problem serves B instances.

``matmul_precision`` ('high' or 'highest', or None for the process's own
setting) scopes ``torch``'s float32 matmul precision to the problem's
operators: every method, and every operator a point-frozen factory returns,
sets it on entry and restores it on exit, so the derivative products that
autograd forms inside run at it too, as the JAX package's precision
reaches a dot's transposes.  On CUDA 'high' is TF32; on the CPU both
settings compute full float32.

Sign conventions (as in the reference):
  feasible      <=>  ineq(x) <= 0 elementwise (and eq(x) = 0)
  slack         c(x) = -ineq(x) > 0 at strictly feasible points
  Lagrangian    L(x, y, z) = f(x) + y . ineq(x) + z . eq(x),  y >= 0

Point-frozen factories (``lag_rhess_at``, ``gx_at``, ``gx_adj_at``,
``hx_at``) do the
point-dependent work once per solver step, like the JAX package's
``linearize``/``vjp``.  ``torch.func.linearize`` traces through ``make_fx``
and costs seconds per call, so the Hessian-vector product is instead the
pullback of a frozen ``vjp`` of the Lagrangian gradient: the Hessian is
symmetric, so that pullback is exactly H v, at a fraction of the cost of a
per-application ``jvp(grad(...))``.

A family may give its derivatives in closed form (``derivatives``):
lane-batched functions that replace torch.func in ``lag_rhess_at``,
``gx_at`` and ``gx_adj``, the operators the tCG applies at every
iteration.  Through torch.func (a pullback replayed under ``vmap``) one
application is about a thousand host operators; a closed form is a few
dozen.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.func import grad, jvp, vjp, vmap

from riptrm_torch.config import matmul_precision as _precision_scope
from riptrm_torch.manifolds.base import Manifold
from riptrm_torch.problems import structured
from riptrm_torch.utils.spans import span


def scoped(method):
    """A ``Problem`` method run under the problem's ``matmul_precision``;
    an operator it returns (a point-frozen factory's) runs under it too."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        precision = self.matmul_precision
        if precision is None:
            return method(self, *args, **kwargs)
        with _precision_scope(precision):
            out = method(self, *args, **kwargs)
        if not callable(out):
            return out

        def op(*a):
            with _precision_scope(precision):
                return out(*a)

        return op

    return run


@dataclasses.dataclass(frozen=True)
class Problem:
    manifold: Manifold
    cost_fn: Callable[[torch.Tensor], torch.Tensor]  # per lane: point -> scalar
    ineq_fn: Optional[Callable] = None  # per lane: point -> [m], feasible <= 0
    eq_fn: Optional[Callable] = None  # per lane: point -> [l]
    x0: Any = None  # one point, [n] or [n, p]
    y0: Any = None  # [m]
    z0: Any = None  # [l]
    num_ineq: int = 0
    num_eq: int = 0
    # Manifold-constraint violation per lane, point -> scalar (residual term)
    manvio_fn: Optional[Callable] = None
    # Extra per-iteration metrics, (problem, x, y, z, eval_dict) -> eval_dict
    callback: Optional[Callable] = None
    # The family's declaration of its fast paths: {"kind": "sphere_quadratic",
    # "Zs": ...} or {"kind": "stiefel_bound", "Zs", "bound", "d"} (None:
    # none).  Only the problem layer reads it (problems/structured.py,
    # through fused_tcg_at, hessian_coords_at and ineq_rows_at below).
    structure: Optional[dict] = None
    # Per-lane instance data [B, ...]: the last argument of every per-lane
    # function above, mapped with the point (None: no such argument).
    data: Any = None
    # float32 matmul precision of the problem's operators ('high',
    # 'highest' or None), set and restored around each of them.
    matmul_precision: Optional[str] = None
    # Closed-form lane-batched derivatives (None: torch.func), for a problem
    # with inequality constraints only and no per-lane data: an object with
    #   lag_at(x, y) -> (egrad of L, v -> ehess of L [v]) and
    #   ineq_at(x) -> (dx -> d ineq(x) [dx], w -> egrad of w . ineq(x)),
    # and optionally barrier_hvp_at(x, y, c) -> the barrier-KKT operator
    # whole, or None for a point it does not take.  Only the problem's own
    # methods below read it.
    derivatives: Optional[Any] = None

    # The family's fast paths, each None where it has none
    # (problems/structured.py): the fused tCG, the closed form of the
    # Lagrangian's Hessian in the tangent basis, and the constraint rows.
    fused_tcg_at = structured.fused_tcg_at
    hessian_coords_at = structured.hessian_coords_at
    ineq_rows_at = structured.ineq_rows_at

    @property
    def has_ineq(self) -> bool:
        return self.num_ineq > 0

    @property
    def has_eq(self) -> bool:
        return self.num_eq > 0

    def _map(self, fn):
        """``fn`` of one lane mapped over the lanes, each lane's data
        appended to its arguments."""
        data = () if self.data is None else (self.data,)
        return lambda *args: vmap(fn)(*args, *data)

    # ------------------------------------------------------------------
    # Values over lanes
    # ------------------------------------------------------------------
    @scoped
    def cost(self, x):
        return self._map(self.cost_fn)(x)

    @scoped
    def ineq_val(self, x):
        if not self.has_ineq:
            return x.new_zeros((x.shape[0], 0))
        return self._map(self.ineq_fn)(x)

    @scoped
    def eq_val(self, x):
        if not self.has_eq:
            return x.new_zeros((x.shape[0], 0))
        return self._map(self.eq_fn)(x)

    def slack(self, x):
        """c(x) = -ineq(x); positive at strictly feasible points."""
        return -self.ineq_val(x)

    @scoped
    def manvio(self, x):
        if self.manvio_fn is None:
            return x.new_zeros(x.shape[0])
        return self._map(self.manvio_fn)(x)

    @scoped
    def apply_callback(self, x, y, z, ev):
        if self.callback is None:
            return ev
        with span("riptrm.callback"):
            return self.callback(self, x, y, z, ev)

    # ------------------------------------------------------------------
    # First-order operators
    # ------------------------------------------------------------------
    @scoped
    def egrad(self, x):
        return self._map(grad(self.cost_fn))(x)

    def rgrad(self, x):
        return self.manifold.egrad2rgrad(x, self.egrad(x))

    @scoped
    def rhess(self, x, v):
        """Riemannian Hessian-vector product of the cost: one jvp of the
        gradient."""
        eg, eh = jvp(self._map(grad(self.cost_fn)), (x,), (v,))
        return self.manifold.ehess2rhess(x, eg, eh, v)

    # ------------------------------------------------------------------
    # Lagrangian operators (all constraints at once)
    # ------------------------------------------------------------------
    def _lag(self, x, y, z, *data):
        val = self.cost_fn(x, *data)
        if self.has_ineq:
            val = val + torch.dot(y, self.ineq_fn(x, *data))
        if self.has_eq:
            val = val + torch.dot(z, self.eq_fn(x, *data))
        return val

    def _z(self, x, z):
        return x.new_zeros((x.shape[0], 0)) if z is None else z

    @property
    def _closed_form(self) -> bool:
        return self.derivatives is not None and not self.has_eq and self.data is None

    @scoped
    def lag_egrad(self, x, y, z=None):
        return self._map(grad(self._lag))(x, y, self._z(x, z))

    def lag_rgrad(self, x, y, z=None):
        """Riemannian gradient of the Lagrangian."""
        return self.manifold.egrad2rgrad(x, self.lag_egrad(x, y, z))

    @scoped
    def lag_rhess(self, x, y, v, z=None):
        """Riemannian Hessian-vector product of the Lagrangian: one jvp of
        its gradient (``lag_rhess_at`` freezes the point's work instead)."""
        z = self._z(x, z)
        eg, eh = jvp(lambda xx: self._map(grad(self._lag))(xx, y, z), (x,), (v,))
        return self.manifold.ehess2rhess(x, eg, eh, v)

    @scoped
    def lag_rhess_at(self, x, y, z=None):
        """Returns v -> Riemannian Hessian-vector product of L at (x, y, z).

        The frozen pullback of the lane-batched Lagrangian gradient is
        H v (the Hessian is symmetric, the lanes independent)."""
        if self._closed_form:
            eg, ehvp = self.derivatives.lag_at(x, y)
            return lambda v: self.manifold.ehess2rhess(x, eg, ehvp(v), v)
        z = self._z(x, z)
        eg, pullback = vjp(lambda xx: self._map(grad(self._lag))(xx, y, z), x)

        def hvp(v):
            (eh,) = pullback(v)
            return self.manifold.ehess2rhess(x, eg, eh, v)

        return hvp

    @scoped
    def barrier_hvp_at(self, x, y, c):
        """Returns dx -> Hess_x L[dx] + Gx(y * Gxaj(dx) / c) as one operator
        where the family's closed form gives one (``barrier_hvp_at`` of
        ``derivatives``, for the points it takes), else None."""
        fn = getattr(self.derivatives, "barrier_hvp_at", None) if self._closed_form else None
        return None if fn is None else fn(x, y, c)

    # ------------------------------------------------------------------
    # Constraint-Jacobian operators in terms of the slack c = -g
    # ------------------------------------------------------------------
    @scoped
    def gx_adj(self, x, dx):
        """Gxaj(dx)_i = d/dt c_i(x + t dx): one jvp."""
        if self._closed_form:
            return -self.derivatives.ineq_at(x)[0](dx)
        _, dg = jvp(self._map(self.ineq_fn), (x,), (dx,))
        return -dg

    @scoped
    def gx_at(self, x):
        """Returns v -> Gx(v), the Riemannian gradient of x -> v . c(x),
        with the constraint pullback frozen."""
        if self._closed_form:
            ineq_vjp = self.derivatives.ineq_at(x)[1]
            return lambda v: self.manifold.egrad2rgrad(x, ineq_vjp(-v))
        _, pullback = vjp(self._map(self.ineq_fn), x)

        def gx(v):
            (eg,) = pullback(-v)
            return self.manifold.egrad2rgrad(x, eg)

        return gx

    @scoped
    def gx_adj_at(self, x):
        """Returns dx -> Gxaj(dx) at the point x."""
        if self._closed_form:
            ineq_jvp = self.derivatives.ineq_at(x)[0]
            return lambda dx: -ineq_jvp(dx)
        return lambda dx: self.gx_adj(x, dx)

    def gx(self, x, v):
        """Gx(v) = sum_i v_i (-rgrad g_i), the per-call form of ``gx_at``."""
        return self.gx_at(x)(v)

    # ------------------------------------------------------------------
    # Equality-constraint operators (the analogues of gx / gx_adj on h)
    # ------------------------------------------------------------------
    @scoped
    def hx_at(self, x):
        """Returns v -> Hx(v), the Riemannian gradient of x -> v . h(x),
        with the equality pullback frozen."""
        _, pullback = vjp(self._map(self.eq_fn), x)

        def hx(v):
            (eg,) = pullback(v)
            return self.manifold.egrad2rgrad(x, eg)

        return hx

    def hx(self, x, v):
        """Hx(v) = sum_i v_i rgrad h_i: one vjp."""
        return self.hx_at(x)(v)

    @scoped
    def hx_adj(self, x, dx):
        """Hxaj(dx)_i = d/dt h_i(x + t dx): one jvp."""
        _, dh = jvp(self._map(self.eq_fn), (x,), (dx,))
        return dh

"""The fast paths of the families that declare a ``Problem.structure``: the
fused tCG kernels and the sphere's closed forms.

The solvers ask the problem (``Problem.fused_tcg_at``,
``hessian_coords_at``, ``ineq_rows_at``), the problem asks this module, and
this module alone reads a structure's ``kind``; each entry returns None
where the family has no such path, and ``structure=None`` has none.

``sphere_quadratic`` (NonnegPCA: cost -x'Zs x on the sphere, constraints
-x): the tCG runs as K2 at one lane and K3 at several wherever
``ops/kernels.py::tcg_plan`` has a kernel route (n <= 7232); the
Lagrangian's Hessian in the Householder basis is one O(n^2) congruence of
its ambient form, and the constraint rows are -B'.  ``stiefel_bound``
(BoundedPCA): the tCG runs as the Stiefel-bound kernel at every B wherever
``stiefel_plan`` fits.  Both kernels share one Zs across their lanes, so a
Zs with a lane axis [B, n, n] (instance batching) runs one one-lane launch
a lane, as the JAX package's vmap rules ``lax.map`` one-lane kernels over a
batched Zs.

The kernels are looked up on ``riptrm_torch.ops.kernels`` at each call, so
a caller that replaces one there (a probe, a test) is obeyed.
"""

from __future__ import annotations

import torch

from riptrm_torch.ops import kernels
from riptrm_torch.ops.basis import sphere_householder_congruence, sphere_householder_coords
from riptrm_torch.utils.lanes import dot, sym_mv


def _kind(problem):
    return (problem.structure or {}).get("kind")


def fused_tcg_at(problem, x, y, c):
    """The tCG of the lanes ``x`` at multipliers ``y`` and slacks ``c`` as
    one hand-written kernel: a function ``(cx, radius, **tcg_kw) -> (dx,
    h_dx, iters, code)`` in ``x``'s dtype, or None where no kernel's plan
    takes the lanes (the plain ``truncated_cg`` runs there).  Decided by the
    kernels' plans before any launch, as the JAX package gates its kernels
    on ``fits_in_vmem``."""
    kind, man = _kind(problem), problem.manifold
    if kind not in ("sphere_quadratic", "stiefel_bound"):
        return None
    zs, d = problem.structure["Zs"], problem.structure.get("d")
    per_lane = zs.ndim == 3
    lanes, sms = 1 if per_lane else x.shape[0], kernels._sms(x.device)
    if kind == "sphere_quadratic" and kernels.tcg_plan(man.n, lanes, sms).route == "plain":
        return None
    if kind == "stiefel_bound":
        try:
            kernels.stiefel_plan(man.n, man.p, lanes, sms)
        except ValueError:
            return None

    def launch(zs, x, y, c, cx, radius, **tcg_kw):
        """The lanes of ``x`` against one Zs: the Stiefel-bound kernel at
        every B (one lane is B = 1, as in JAX), or K2 (one lane) or K3."""
        if kind == "stiefel_bound":
            ws, ss = kernels.stiefel_bound_pieces(zs, d, x, y, c)
            return kernels.fused_tcg_stiefel_bound_batched(zs, d, x, ws, ss, cx, radius, **tcg_kw)
        w = y / c
        if x.shape[0] == 1:
            dx, h_dx, it, code = kernels.fused_tcg_sphere_quadratic(
                zs, x[0], w[0], cx[0], radius[0], **tcg_kw)
            return dx[None], h_dx[None], it.reshape(1), code.reshape(1)
        return kernels.fused_tcg_sphere_quadratic_batched(zs, x, w, cx, radius, **tcg_kw)

    def tcg(cx, radius, **tcg_kw):
        if per_lane:
            outs = [launch(zs[i], x[i:i + 1], y[i:i + 1], c[i:i + 1], cx[i:i + 1],
                           radius[i:i + 1], **tcg_kw) for i in range(x.shape[0])]
            dx, h_dx, it, code = (torch.cat(parts) for parts in zip(*outs))
        else:
            dx, h_dx, it, code = launch(zs, x, y, c, cx, radius, **tcg_kw)
        return dx.to(x.dtype), h_dx.to(x.dtype), it, code

    return tcg


def hessian_coords_at(problem, x, y):
    """The Lagrangian's Hessian at (x, y) in the tangent basis of
    ``manifold.basis(x)`` in closed form, or None: a function ``(w=None,
    v=None) -> (h, cx)``, h [B, dim, dim] the matrix of Hess_x L[dx] +
    Gx(w * Gxaj(dx)) (w None: Hess_x L alone) and cx [B, dim] the
    coordinates of grad f - Gx(v) (None without v).  On a
    ``sphere_quadratic`` problem the ambient form is A = -2 Zs + diag(w)
    with curvature kappa = x'(-2 Zs x - y), so h is one congruence per lane,
    not dim HVPs."""
    if _kind(problem) != "sphere_quadratic" or problem.has_eq:
        return None

    def coords(w=None, v=None):
        zs = problem.structure["Zs"].to(y.dtype)  # [n, n], or [B, n, n] per lane
        zsx = sym_mv(zs, x)
        a_mat = ((-2.0 * zs).expand(x.shape[0], *zs.shape[-2:]) if w is None
                 else -2.0 * zs + torch.diag_embed(w))
        h = sphere_householder_congruence(x, a_mat, dot(x, -2.0 * zsx - y))
        return h, None if v is None else sphere_householder_coords(x, -2.0 * zsx - v)

    return coords


def ineq_rows_at(problem, x, basis):
    """The rows [B, m, dim] of the inequality constraints' Riemannian
    gradients in ``basis`` in closed form, or None: on a
    ``sphere_quadratic`` problem g(x) = -x, so G = -B'."""
    if _kind(problem) != "sphere_quadratic":
        return None
    return -basis.mT

"""Chained Rosenbrock minimisation on the Grassmann manifold Gr(n, k).

Counterpart of ``riptrm_tpu/problems/rosenbrock.py``: the chained
Rosenbrock sum of the frame's entries (one shifted difference), the nk
constraints x_i >= -0.01, the rank-check manifold violation, and the
second-order-residual callback: the least eigenvalue of Hess_x L
restricted to the null space of the active constraint gradients, and its
condition number there.  The callback is branch-free over lanes, as the
JAX one: the active set is a mask, the null-space restriction a projector
from one SVD, and the variable null-space dimension is handled by
shifting the complement's spectrum out of the way.  It runs at every
evaluation that reads it: every step of ``RIPTRM.run`` and of the
baseline solvers' host runners (one SVD of the [nk, dim] active gradient
rows, the Hessian materialised in the tangent basis and one ``eigvalsh``
per lane), not in the fixed-budget loops, which read only the residual.
"""

from __future__ import annotations

import math

import torch

from riptrm_torch.config import resolve
from riptrm_torch.manifolds import Grassmann
from riptrm_torch.ops.basis import constraint_grad_rows, materialize_symmetrized
from riptrm_torch.ops.spectrum import eigvalsh_nan
from riptrm_torch.problems.problem import Problem


def second_order_residual(problem, x, y, z, *, active_tol=1e-5, linindtol=1e-12):
    """(least eigenvalue, condition number) per lane, each [B], of Hess_x L
    restricted to the null space of the active constraint gradients at the
    lanes of x [B, n, k]."""
    man = problem.manifold
    dim = man.dim
    basis = man.basis(x)
    g = problem.ineq_val(x)
    active = torch.abs(g) < active_tol  # [B, m]

    # coordinate rows of the Riemannian constraint gradients (one vjp)
    g_rows = constraint_grad_rows(man, x, basis, problem.ineq_fn, problem.num_ineq,
                                  dtype=g.dtype)
    ga = torch.where(active[..., None], g_rows, torch.zeros_like(g_rows))

    # projector onto the span of the active gradients, by SVD with a rank
    # tolerance
    _, s, vh = torch.linalg.svd(ga, full_matrices=False)
    rank_mask = (s > linindtol).to(g.dtype)
    r = torch.sum(s > linindtol, dim=-1)
    p_span = (vh.mT * rank_mask[:, None, :]) @ vh
    eye = torch.eye(dim, dtype=g.dtype, device=g.device)
    p_null = eye - p_span

    h_mat = materialize_symmetrized(man, x, basis, problem.lag_rhess_at(x, y, z))
    big = (1.0 + torch.linalg.matrix_norm(h_mat)) * 1e3
    shifted = p_null @ h_mat @ p_null + big[:, None, None] * p_span
    w = eigvalsh_nan(shifted)  # ascending; the first dim - r are the null space's

    nulldim = dim - r
    has_null = nulldim > 0
    mineig = torch.where(has_null, w[:, 0], torch.zeros_like(w[:, 0]))
    idx = torch.clamp(nulldim - 1, 0, dim - 1)
    max_null = torch.gather(w, 1, idx[:, None])[:, 0]
    nan = torch.full_like(mineig, math.nan)
    condnum = torch.where(has_null, max_null / mineig, nan)
    return mineig, condnum


def make_problem(n: int, k: int, alpha: float = 1e7, dtype=None, device=None) -> Problem:
    """Gr(n, k), x0 = |I[:, :k]|, y0 = 1 (``Rosenbrock/coordinator.py``)."""
    dtype, device = resolve(dtype, device)
    m = n * k

    def cost_fn(x):
        v = x.reshape(-1)
        return torch.sum(alpha * (v[1:] - v[:-1]) ** 2 + (1.0 - v[:-1]) ** 2)

    def ineq_fn(x):
        return -x.reshape(-1) - 0.01  # feasible: x_i >= -0.01

    def manvio_fn(x):
        # the rank check (simulator.py:107-114)
        rank = torch.sum(torch.linalg.svdvals(x) > 1e-10)
        return torch.where(rank == k, torch.zeros((), dtype=x.dtype, device=x.device),
                           torch.full((), math.inf, dtype=x.dtype, device=x.device))

    def callback(prob, x, y, z, ev):
        mineig, condnum = second_order_residual(prob, x, y, z)
        ev["second_order_residual"] = mineig
        ev["condition_number"] = condnum
        return ev

    x0 = torch.abs(torch.eye(n, dtype=dtype, device=device)[:, :k])
    return Problem(
        manifold=Grassmann(n, k),
        cost_fn=cost_fn,
        ineq_fn=ineq_fn,
        x0=x0,
        y0=torch.ones(m, dtype=dtype, device=device),
        z0=torch.zeros(0, dtype=dtype, device=device),
        num_ineq=m,
        num_eq=0,
        manvio_fn=manvio_fn,
        callback=callback,
    )


def sweep_starts(problem, generator, lanes, step=5e-3):
    """``lanes`` starts near x0: retractions of small random tangents, as the
    JAX package's chip sweeps draw them (on the manifold and, at step 5e-3,
    strictly feasible).  [lanes, n, k] on x0's device."""
    man = problem.manifold
    x0 = problem.x0[None].expand((lanes,) + tuple(problem.x0.shape))
    v = man.random_tangent(x0, generator)
    return man.retract(x0, step * v)

"""Unconstrained Riemannian subsolvers over lanes: steepest descent and
conjugate gradient with a backtracking line search.

Counterpart of ``riptrm_tpu/solvers/subsolvers.py`` (pymanopt's
``SteepestDescent`` / ``ConjugateGradient`` as RALM consumes them).  The
JAX ``while_loop``s are lane-masked ``utils/lanes.py::lane_loop``s (eagerly
one host check an iteration); the line search nests inside the optimiser's loop as a mask of
its own, started on the lanes the optimiser still runs.  A lane that
stops keeps its values exactly.  ``cost`` maps points [B, ...] to [B],
``rgrad`` to tangents [B, ...].
"""

from __future__ import annotations

import dataclasses

import torch

from riptrm_torch.utils.lanes import bcast as _bc
from riptrm_torch.utils.lanes import lane_loop
from riptrm_torch.utils.lanes import where_lanes as _lanes
from riptrm_torch.utils.spans import span


def _backtracking_line_search(manifold, cost, x, d, f0, df0, alpha0, active, *,
                              contraction=0.5, sufficient_decrease=1e-4, max_steps=25):
    """pymanopt's BackTrackingLineSearcher on the ``active`` lanes: returns
    (x_new, f_new, alpha, step_count), the step refused (alpha 0) where no
    trial decreased the cost."""

    def try_alpha(alpha):
        x_new = manifold.retract(x, _bc(alpha, d) * d)
        return x_new, cost(x_new)

    def running_lanes(alpha, x_new, f_new, k):
        return active & (f_new > f0 + sufficient_decrease * alpha * df0) & (k <= max_steps)

    def backtrack(_, alpha, x_new, f_new, k):
        run = running_lanes(alpha, x_new, f_new, k)
        alpha_t = alpha * contraction
        x_t, f_t = try_alpha(alpha_t)
        alpha = torch.where(run, alpha_t, alpha)
        x_new = _lanes(run, x_t, x_new)
        f_new = torch.where(run, f_t, f_new)
        return alpha, x_new, f_new, k + run.to(k.dtype)

    with span("riptrm.ralm.line_search"):
        alpha = alpha0
        x_new, f_new = try_alpha(alpha)
        k = torch.ones_like(alpha, dtype=torch.int64)
        alpha, x_new, f_new, k = lane_loop(lambda *c: running_lanes(*c).any(), backtrack,
                                           (alpha, x_new, f_new, k))
        no_step = f_new > f0
        return (_lanes(no_step, x, x_new), torch.where(no_step, f0, f_new),
                torch.where(no_step, torch.zeros_like(alpha), alpha), k)


@dataclasses.dataclass
class SubsolverResult:
    point: torch.Tensor
    cost: torch.Tensor
    gradient_norm: torch.Tensor
    iterations: torch.Tensor


def _warm_alpha(have_oldf, f, oldf, df0, gradnorm, optimism, initial_step_size):
    """pymanopt's optimism rule for the line search's first trial."""
    alpha = torch.where(
        have_oldf,
        optimism * 2.0 * (f - oldf) / torch.where(df0 == 0, torch.ones_like(df0), df0),
        initial_step_size / torch.clamp(gradnorm, min=1e-30),
    )
    return torch.clamp(alpha, min=1e-30)


def steepest_descent(manifold, cost, rgrad, x0, *, max_iterations=200, min_gradient_norm=1e-6,
                     min_step_size=1e-10, initial_step_size=1.0, optimism=2.0) -> SubsolverResult:
    """Riemannian steepest descent on every lane of ``x0``
    (``min_gradient_norm`` a number or [B])."""
    x, f = x0, cost(x0)
    g = rgrad(x0)
    gradnorm = manifold.norm(x0, g)
    oldf = f
    have_oldf = torch.zeros_like(f, dtype=torch.bool)
    stepsize = torch.full_like(f, float("inf"))
    k = torch.zeros_like(f, dtype=torch.int64)

    def lanes_on(x, g, f, oldf, have_oldf, stepsize, gradnorm, k):
        return (gradnorm >= min_gradient_norm) & (stepsize >= min_step_size) & (k < max_iterations)

    def iterate(_, x, g, f, oldf, have_oldf, stepsize, gradnorm, k):
        active = lanes_on(x, g, f, oldf, have_oldf, stepsize, gradnorm, k)
        df0 = -(gradnorm**2)
        alpha = _warm_alpha(have_oldf, f, oldf, df0, gradnorm, optimism, initial_step_size)
        x_n, f_n, alpha, _ = _backtracking_line_search(manifold, cost, x, -g, f, df0, alpha,
                                                       active)
        g_n = rgrad(x_n)
        x, g = _lanes(active, x_n, x), _lanes(active, g_n, g)
        oldf = torch.where(active, f, oldf)
        f = torch.where(active, f_n, f)
        have_oldf = have_oldf | active
        stepsize = torch.where(active, alpha * gradnorm, stepsize)
        gradnorm = torch.where(active, manifold.norm(x_n, g_n), gradnorm)
        return x, g, f, oldf, have_oldf, stepsize, gradnorm, k + active.to(k.dtype)

    x, _, f, _, _, _, gradnorm, k = lane_loop(
        lambda *c: lanes_on(*c).any(), iterate,
        (x, g, f, oldf, have_oldf, stepsize, gradnorm, k))
    return SubsolverResult(x, f, gradnorm, k)


def conjugate_gradient(manifold, cost, rgrad, x0, *, max_iterations=200, min_gradient_norm=1e-6,
                       min_step_size=1e-10, initial_step_size=1.0, optimism=2.0) -> SubsolverResult:
    """Riemannian conjugate gradient (Polak-Ribiere+, projection transport)
    with the same line search, on every lane of ``x0``."""
    x, f = x0, cost(x0)
    g = rgrad(x0)
    d = -g
    gradnorm = manifold.norm(x0, g)
    oldf = f
    have_oldf = torch.zeros_like(f, dtype=torch.bool)
    stepsize = torch.full_like(f, float("inf"))
    k = torch.zeros_like(f, dtype=torch.int64)

    def lanes_on(x, g, d, f, oldf, have_oldf, stepsize, gradnorm, k):
        return (gradnorm >= min_gradient_norm) & (stepsize >= min_step_size) & (k < max_iterations)

    def iterate(_, x, g, d, f, oldf, have_oldf, stepsize, gradnorm, k):
        active = lanes_on(x, g, d, f, oldf, have_oldf, stepsize, gradnorm, k)
        df0 = manifold.inner(x, g, d)
        # steepest descent where d is not a descent direction
        use_sd = df0 >= 0
        d_use = _lanes(use_sd, -g, d)
        df0 = torch.where(use_sd, -(gradnorm**2), df0)
        alpha = _warm_alpha(have_oldf, f, oldf, df0, gradnorm, optimism, initial_step_size)
        x_n, f_n, alpha, _ = _backtracking_line_search(manifold, cost, x, d_use, f, df0, alpha,
                                                       active)
        g_n = rgrad(x_n)
        gradnorm_n = manifold.norm(x_n, g_n)
        g_old_t = manifold.transport(x, x_n, g)
        d_t = manifold.transport(x, x_n, d_use)
        beta = torch.clamp(
            manifold.inner(x_n, g_n, g_n - g_old_t) / torch.clamp(gradnorm**2, min=1e-300),
            min=0.0,
        )
        d_n = -g_n + _bc(beta, d_t) * d_t
        stepsize = torch.where(active, alpha * manifold.norm(x, d_use), stepsize)
        x, g, d = _lanes(active, x_n, x), _lanes(active, g_n, g), _lanes(active, d_n, d)
        oldf = torch.where(active, f, oldf)
        f = torch.where(active, f_n, f)
        have_oldf = have_oldf | active
        gradnorm = torch.where(active, gradnorm_n, gradnorm)
        return x, g, d, f, oldf, have_oldf, stepsize, gradnorm, k + active.to(k.dtype)

    x, _, _, f, _, _, _, gradnorm, k = lane_loop(
        lambda *c: lanes_on(*c).any(), iterate,
        (x, g, d, f, oldf, have_oldf, stepsize, gradnorm, k))
    return SubsolverResult(x, f, gradnorm, k)

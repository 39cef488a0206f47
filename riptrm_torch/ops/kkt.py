"""KKT residual, constraint violations and per-iteration evaluation over
lanes.  Counterpart of ``riptrm_tpu/ops/kkt.py``, with the same log keys."""

from __future__ import annotations

import torch


def _norm(a):
    return torch.linalg.vector_norm(a, dim=-1)


def compute_residual(problem, x, y, z=None):
    """Returns (residual, gradnorm, complvio, nonnegvio, manvio), each [B].

    residual^2 = ||grad_x L||^2 + ||y * g||^2 + ||max(-y,0)||^2
                 + ||max(g,0)||^2 + ||h||^2 + manvio^2
    """
    man = problem.manifold
    gradnorm = man.norm(x, problem.lag_rgrad(x, y, z))
    zero = torch.zeros_like(gradnorm)
    g = problem.ineq_val(x)
    if problem.has_ineq:
        compl = _norm(y * g)
        nonneg = _norm(torch.clamp(-y, min=0.0))
        ineqvio_sq = torch.sum(torch.clamp(g, min=0.0) ** 2, dim=-1)
    else:
        compl = nonneg = ineqvio_sq = zero
    eqvio_sq = torch.sum(problem.eq_val(x) ** 2, dim=-1) if problem.has_eq else zero
    manvio = problem.manvio(x)
    residual = torch.sqrt(
        gradnorm**2 + compl**2 + nonneg**2 + ineqvio_sq + eqvio_sq + manvio**2
    )
    return residual, gradnorm, compl, nonneg, manvio


def compute_maxmean_violations(problem, x):
    """Max / mean of the per-constraint violations, each [B]."""
    parts = []
    if problem.has_ineq:
        parts.append(torch.clamp(problem.ineq_val(x), min=0.0))
    if problem.has_eq:
        parts.append(torch.abs(problem.eq_val(x)))
    if not parts:
        zero = x.new_zeros(x.shape[0])
        return zero, zero
    v = torch.cat(parts, dim=-1)
    return torch.amax(v, dim=-1), torch.mean(v, dim=-1)


def evaluation(problem, x_prev, x, y, z=None, callback=True):
    """Per-iteration metric dict of [B] tensors, with the problem's callback
    metrics unless ``callback`` is False.  Its keys come sorted, as a jitted
    JAX function returns a dict: they set the order of the logs' first
    columns."""
    residual, gradnorm, compl, nonneg, manvio = compute_residual(problem, x, y, z)
    maxvio, meanvio = compute_maxmean_violations(problem, x)
    ev = {
        "cost": problem.cost(x),
        "distance": problem.manifold.dist(x_prev, x),
        "residual": residual,
        "gradnorm": gradnorm,
        "complviolation": compl,
        "dualviolation": nonneg,
        "manviolation": manvio,
        "maxviolation": maxvio,
        "meanviolation": meanvio,
    }
    if callback:
        ev = problem.apply_callback(x, y, z, ev)
    return dict(sorted(ev.items()))

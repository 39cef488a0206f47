"""Steihaug-Toint truncated conjugate gradient on a tangent space, over
lanes.  Counterpart of ``riptrm_tpu/ops/tcg.py``.

The JAX version is one ``lax.while_loop`` per lane and gets its lanes from
``vmap``.  Here every lane runs in lockstep with a done mask: a lane that
stops is frozen at the values it stopped with, and the loop ends when every
lane is done (``utils/lanes.py::lane_loop``: eagerly one host check of "any
lane alive" per iteration, under tracing a ``while_loop`` operator).  At B = 1
this is the JAX function exactly.

Profiler spans (``utils/spans.py``): ``riptrm.tcg.iteration`` around each
lockstep body (the loop's host check stays outside it), ``riptrm.tcg.hvp``
around each Hessian-vector product.

Stop codes:
  0 MAX_INNER_ITER, 1 NEGATIVE_CURVATURE, 2 EXCEEDED_TR, 3 MODEL_INCREASED,
  4 REACHED_TARGET_LINEAR, 5 REACHED_TARGET_SUPERLINEAR
"""

from __future__ import annotations

import torch

from riptrm_torch.utils.lanes import lane_loop
from riptrm_torch.utils.spans import span

STOP_MAX_ITER = 0
STOP_NEG_CURV = 1
STOP_EXCEEDED_TR = 2
STOP_MODEL_INCREASED = 3
STOP_TARGET_LINEAR = 4
STOP_TARGET_SUPERLINEAR = 5


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def truncated_cg(manifold, x, hess, grad, radius, *, theta=1.0, kappa=0.1,
                 mininner=1, maxinner=None):
    """Minimise m(eta) = <grad, eta> + 0.5 <eta, hess(eta)> s.t. ||eta|| <= radius,
    independently on each lane.

    ``x``/``grad`` are lane-batched points and tangents ``[B, ...]`` (``[B, n]``
    on the sphere, ``[B, n, p]`` on Stiefel), ``radius`` is [B] (or a
    scalar), ``hess`` maps tangents to tangents.  Returns (eta, Heta,
    iterations [B], stop_code [B]), the counts as int32.
    """
    if maxinner is None:
        maxinner = manifold.dim
    inner = manifold.inner_at(x)
    b = x.shape[0]
    tail = (1,) * (x.ndim - 1)

    def _col(s):
        """[B] -> [B, 1, ...] for broadcasting a per-lane scalar over a point."""
        return s.reshape(s.shape + tail)

    radius = torch.broadcast_to(torch.as_tensor(radius, dtype=grad.dtype,
                                                device=grad.device), (b,))
    rad2 = radius**2

    eta = manifold.zero_vector(x)
    heta = manifold.zero_vector(x)
    r = grad
    z_r = inner(r, r)
    norm_r0 = torch.sqrt(z_r)
    delta = -r
    target = norm_r0 * torch.clamp(norm_r0**theta, max=kappa)
    linear = kappa < norm_r0**theta

    zero = torch.zeros_like(norm_r0)
    e_pe, d_pd, e_pd, model = zero, z_r, zero, zero
    iters = torch.zeros(b, dtype=torch.int32, device=x.device)
    code = torch.full((b,), STOP_MAX_ITER, dtype=torch.int32, device=x.device)
    done = torch.zeros(b, dtype=torch.bool, device=x.device)

    def running(*carry):
        return ~carry[-1].all()

    def body(*carry):
        with span("riptrm.tcg.iteration"):
            return step(*carry)

    def step(j, eta, heta, r, z_r, delta, e_pe, d_pd, e_pd, model, iters, code, done):
        alive = ~done
        with span("riptrm.tcg.hvp"):
            hdelta = hess(delta)
        d_hd = inner(delta, hdelta)
        alpha = _safe_div(z_r, d_hd)
        e_pe_new = e_pe + 2.0 * alpha * e_pd + alpha**2 * d_pd

        bail = (d_hd <= 0) | (e_pe_new >= rad2)
        # Boundary step to the trust-region edge.
        disc = torch.clamp(e_pd**2 + d_pd * (rad2 - e_pe), min=0.0)
        tau = _safe_div(-e_pd + torch.sqrt(disc), d_pd)

        eta_b = eta + _col(tau) * delta
        heta_b = heta + _col(tau) * hdelta
        eta_c = eta + _col(alpha) * delta
        heta_c = heta + _col(alpha) * hdelta
        model_c = inner(eta_c, grad) + 0.5 * inner(eta_c, heta_c)
        model_inc = model_c >= model

        r_new = r + _col(alpha) * hdelta
        z_r_new = inner(r_new, r_new)
        hit = (j + 1 > mininner) & (torch.sqrt(z_r_new) <= target)
        beta = _safe_div(z_r_new, z_r)
        delta_new = manifold.proj_tangent(x, -r_new + _col(beta) * delta)

        done_now = bail | model_inc | hit
        code_new = torch.where(
            bail,
            torch.where(d_hd <= 0, STOP_NEG_CURV, STOP_EXCEEDED_TR),
            torch.where(
                model_inc,
                STOP_MODEL_INCREASED,
                torch.where(
                    hit,
                    torch.where(linear, STOP_TARGET_LINEAR, STOP_TARGET_SUPERLINEAR),
                    STOP_MAX_ITER,
                ),
            ),
        ).to(torch.int32)

        def pick(a_bail, a_keep, a_accept):
            return torch.where(
                _col(bail), a_bail, torch.where(_col(model_inc), a_keep, a_accept)
            )

        # Lanes already done keep every value they stopped with.
        a, a1 = alive, _col(alive)
        eta = torch.where(a1, pick(eta_b, eta, eta_c), eta)
        heta = torch.where(a1, pick(heta_b, heta, heta_c), heta)
        r = torch.where(a1, r_new, r)
        delta = torch.where(a1, delta_new, delta)
        live = a & ~done_now
        e_pe_next = torch.where(live, e_pe_new, e_pe)
        d_pd_next = torch.where(live, z_r_new + beta**2 * d_pd, d_pd)
        e_pd = torch.where(live, beta * (e_pd + alpha * d_pd), e_pd)
        e_pe, d_pd = e_pe_next, d_pd_next
        z_r = torch.where(live, z_r_new, z_r)
        model = torch.where(live, model_c, model)  # model_inc implies done_now
        iters = iters + a.to(torch.int32)
        code = torch.where(a, code_new, code)
        done = done | done_now
        return eta, heta, r, z_r, delta, e_pe, d_pd, e_pd, model, iters, code, done

    carry = (eta, heta, r, z_r, delta, e_pe, d_pd, e_pd, model, iters, code, done)
    eta, heta, _, _, _, _, _, _, _, iters, code, _ = lane_loop(running, body, carry, maxinner)
    return eta, heta, iters, code

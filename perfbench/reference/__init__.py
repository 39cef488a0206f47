"""Plain references that judge the program's answers.

Each family module works out, from the seeded inputs alone, the KKT
residual of the answers the program returned, and the Hessian image of
the steps the program's tCG returned; it also holds the plain tCG that
stands in for the program's in the lower-precision control.
Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

import torch

# stop codes of a tCG lane
MAX_ITER, NEG_CURV, EXCEEDED_TR, MODEL_INCREASED, TARGET_LINEAR, TARGET_SUPERLINEAR = range(6)


def kkt_residual(rgrad, g, y, manvio):
    """sqrt(||grad_x L||^2 + ||y o g||^2 + ||max(-y, 0)||^2 + ||max(g, 0)||^2
    + manvio^2) over lanes: the Riemannian Lagrangian gradient ``rgrad``
    [L, ...], the constraint values ``g`` [L, m] (feasible where <= 0),
    their multipliers ``y`` [L, m] and the distance from the manifold
    ``manvio`` [L]."""
    parts = (rgrad.flatten(1), y * g, torch.clamp(-y, min=0.0), torch.clamp(g, min=0.0))
    total = sum(torch.sum(a * a, dim=1) for a in parts)
    return torch.sqrt(total + manvio * manvio)


def truncated_cg(hess, proj, grad, radius, *, theta, kappa, mininner, maxinner):
    """Steihaug-Toint truncated CG for min <g, e> + <e, H e>/2 subject to
    ||e|| <= radius, on each lane of ``grad`` [B, n] (tangent vectors;
    ``hess`` and ``proj`` map [B, n] tangents to tangents).  A lane stops
    at negative curvature or the trust-region edge (stepping to the
    edge), when the model would increase (keeping its step), at the
    target ||r|| <= ||g|| min(kappa, ||g||^theta) after ``mininner``
    iterations, or after ``maxinner``.  Returns (eta, H eta, iterations
    [B], stop codes [B])."""
    b = grad.shape[0]

    def dot(u, v):
        return torch.sum(u * v, dim=1)

    def col(s):
        return s[:, None]

    def safe(d):
        return torch.where(d == 0, torch.ones_like(d), d)

    rad2 = torch.broadcast_to(torch.as_tensor(radius, dtype=grad.dtype, device=grad.device),
                              (b,)) ** 2
    eta, heta, r = torch.zeros_like(grad), torch.zeros_like(grad), grad
    z_r = dot(r, r)
    norm_g = torch.sqrt(z_r)
    target = norm_g * torch.clamp(norm_g ** theta, max=kappa)
    linear = kappa < norm_g ** theta
    delta = -r
    zero = torch.zeros_like(z_r)
    e_pe, d_pd, e_pd, model = zero, z_r, zero, zero
    iters = torch.zeros(b, dtype=torch.int32, device=grad.device)
    codes = torch.full((b,), MAX_ITER, dtype=torch.int32, device=grad.device)
    done = torch.zeros(b, dtype=torch.bool, device=grad.device)
    for j in range(maxinner):
        if bool(done.all()):
            break
        hd = hess(delta)
        d_hd = dot(delta, hd)
        alpha = z_r / safe(d_hd)
        e_pe_new = e_pe + 2.0 * alpha * e_pd + alpha ** 2 * d_pd
        neg = d_hd <= 0
        edge = neg | (e_pe_new >= rad2)
        tau = (-e_pd + torch.sqrt(torch.clamp(e_pd ** 2 + d_pd * (rad2 - e_pe), min=0.0))) \
            / safe(d_pd)
        eta_c, heta_c = eta + col(alpha) * delta, heta + col(alpha) * hd
        model_c = dot(eta_c, grad) + 0.5 * dot(eta_c, heta_c)
        worse = ~edge & (model_c >= model)
        r_new = r + col(alpha) * hd
        z_new = dot(r_new, r_new)
        hit = (j + 1 > mininner) & (torch.sqrt(z_new) <= target)
        beta = z_new / safe(z_r)
        alive, stop = ~done, edge | worse | hit
        a = col(alive)
        eta = torch.where(a, torch.where(col(edge), eta + col(tau) * delta,
                                         torch.where(col(worse), eta, eta_c)), eta)
        heta = torch.where(a, torch.where(col(edge), heta + col(tau) * hd,
                                          torch.where(col(worse), heta, heta_c)), heta)
        code = torch.where(edge, torch.where(neg, NEG_CURV, EXCEEDED_TR),
                           torch.where(worse, MODEL_INCREASED,
                                       torch.where(hit, torch.where(linear, TARGET_LINEAR,
                                                                    TARGET_SUPERLINEAR),
                                                   MAX_ITER)))
        codes = torch.where(alive, code.to(torch.int32), codes)
        iters = iters + alive.to(torch.int32)
        live = alive & ~stop
        r = torch.where(a, r_new, r)
        delta = torch.where(a, proj(-r_new + col(beta) * delta), delta)
        e_pe, d_pd, e_pd = (torch.where(live, e_pe_new, e_pe),
                            torch.where(live, z_new + beta ** 2 * d_pd, d_pd),
                            torch.where(live, beta * (e_pd + alpha * d_pd), e_pd))
        z_r = torch.where(live, z_new, z_r)
        model = torch.where(live, model_c, model)
        done = done | stop
    return eta, heta, iters, codes



def share_gap(u, ref):
    """Per lane: ||u - ref|| as a share of ||ref|| on that lane or of the
    median lane's, whichever is larger (some lanes' vectors are all but
    zero)."""
    norm = torch.linalg.vector_norm(ref, dim=1)
    floor = max(float(torch.median(norm)), 1e-30)
    return torch.linalg.vector_norm(u - ref, dim=1) / torch.clamp(norm, min=floor)

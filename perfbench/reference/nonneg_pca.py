"""NonnegPCA: min -x'Zs x on the sphere S^{n-1} subject to x >= 0.

The constraints are g(x) = -x <= 0 with multipliers y, so the Euclidean
gradient of the Lagrangian f + y'g is -2 Zs x - y, projected onto the
tangent space at x by v - (x'v) x; the distance from the sphere is
||x|| - 1.

The interior-point step's subproblem at x, with barrier weights w = y/c
(c = -g = x), has the Hessian of the Lagrangian plus the barrier term on
the tangent space: H v = P(-2 Zs v) + (2 x'Zs x + x'(w o x)) v + P(w o v),
the middle term the sphere's curvature, -x' grad L with x'y = x'(w o x).
"""

from __future__ import annotations

import torch

from perfbench.reference import kkt_residual, share_gap, truncated_cg


def residual(arrays: dict, cfg: dict, x, y):
    """KKT residuals [L] of answers ``x`` [L, n] with multipliers ``y``
    [L, n], all float64 on one device; ``arrays["Z"]`` as generated."""
    z = torch.as_tensor(arrays["Z"], dtype=torch.float64, device=x.device)
    zs = 0.5 * (z + z.T)
    eg = -2.0 * (x @ zs) - y
    rg = eg - torch.sum(x * eg, dim=1, keepdim=True) * x
    return kkt_residual(rg, -x, y, torch.linalg.vector_norm(x, dim=1) - 1.0)


def _hessian(zs, xs, ws):
    """(H, P): the subproblem's Hessian at the lanes' points ``xs`` with
    barrier weights ``ws`` [B, n], and the projection onto their tangent
    spaces, both [B, n] -> [B, n]."""
    def proj(v):
        return v - torch.sum(xs * v, dim=1, keepdim=True) * xs

    curv = 2.0 * torch.sum((xs @ zs) * xs, dim=1) + torch.sum(ws * xs * xs, dim=1)

    def hess(v):
        return -2.0 * proj(v @ zs) + curv[:, None] * v + proj(ws * v)

    return hess, proj


def tcg_gap(arrays: dict, cfg: dict, args, kwargs, out):
    """Per lane [B]: the gap between the Hessian image that the program's
    fused tCG returned with its step, ``out`` = (etas, Hetas, iterations,
    codes), and this float64 Hessian applied to that step, at the point
    and barrier weights the program handed it (``args`` = (zs, xs, ws,
    grads, radii); Zs is worked out again from the instance), as a
    ``share_gap``."""
    _, xs, ws, _, _ = args
    f64 = dict(dtype=torch.float64, device=xs.device)
    z = torch.as_tensor(arrays["Z"], **f64)
    hess, _ = _hessian(0.5 * (z + z.T), xs.to(**f64), ws.to(**f64))
    return share_gap(out[1].to(**f64), hess(out[0].to(**f64))).cpu().numpy()


def tcg_stand_in(zs, xs, ws, grads, radii, *, maxinner, mininner=1, theta=1.0, kappa=0.1):
    """The control's stand-in for the fused batched tCG, with its
    signature and returns: this tCG in float32, its products with Zs in
    TF32."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        hess, proj = _hessian(zs, xs, ws)
        return truncated_cg(hess, proj, grads, torch.as_tensor(radii, device=xs.device),
                            theta=theta, kappa=kappa, mininner=mininner, maxinner=maxinner)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous

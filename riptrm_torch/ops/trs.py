"""Exact trust-region subproblem solvers, over lanes.

Counterpart of ``riptrm_tpu/ops/trs.py``.  Each lane solves

    min 0.5 p'A p + a'p   s.t.  ||p|| <= radius

in metric-orthonormal coordinates, globally (the hard case included):

* ``solve_trs_eig``: from an eigendecomposition A = Q diag(lam) Q', a fixed
  number of safeguarded Newton steps on the secular equation;
* ``solve_trs_ms``: Moré-Sorensen, Cholesky factorisations of A + sig I in
  place of the eigendecomposition.  The JAX ``while_loop`` is a lane-masked
  ``lane_loop`` here (a lane that stops keeps its values; eagerly one host
  check of "any lane running" an iteration), and the hard-case completion,
  a ``lax.cond`` there, runs eagerly only when some lane needs it (under
  tracing on every lane, then selected per lane).  ``torch.linalg.cholesky_ex``
  reports a failed factorisation per lane (``info != 0``) without raising
  or a host sync, where JAX tests the factor for non-finite entries.

Every function takes A [B, n, n], a [B, n], radius [B] and returns (p [B, n],
lam [B], code [B], ...) with code 0 = interior, 1 = boundary, 2 = hard case
and lam the multiplier of the norm constraint.
"""

from __future__ import annotations

import torch

from riptrm_torch.ops.spectrum import eigh_nan, lanczos
from riptrm_torch.utils.lanes import dot as _dot
from riptrm_torch.utils.lanes import lane_loop
from riptrm_torch.utils.lanes import mv as _mv
from riptrm_torch.utils.lanes import tracing


def solve_trs(A, a, radius, *, newton_iters=60):
    """Global TRS solution from one batched ``eigh`` of A."""
    lam, q = eigh_nan(A)  # ascending
    p, lam_out, code, _ = solve_trs_eig(lam, q, a, radius, newton_iters=newton_iters)
    return p, lam_out, code


def solve_trs_eig(lam, Q, a, radius, *, newton_iters=60):
    """``solve_trs`` from a precomputed A = Q diag(lam) Q' (ascending, lam
    [B, n], Q [B, n, n]).  Also returns the solution's eigenbasis
    coordinates p_c (p = Q p_c), whence p'A p = p_c'(lam p_c) and
    A p = Q (lam p_c) without another product with A."""
    dtype = Q.dtype
    radius = torch.broadcast_to(torch.as_tensor(radius, dtype=dtype, device=Q.device),
                                lam.shape[:1])
    b = _mv(Q.mT, a)
    lam1 = lam[:, 0]
    eps = torch.finfo(dtype).eps
    scale = torch.clamp(torch.amax(torch.abs(lam), dim=-1), min=1.0)
    es = (eps * scale)[:, None]

    # ---- interior candidate (A positive definite, the minimiser inside)
    pos_def = lam1 > eps * scale
    p_int_c = -b / torch.where(torch.abs(lam) < es, torch.ones_like(lam), lam)
    interior_ok = pos_def & (_dot(p_int_c, p_int_c) <= radius**2)

    # ---- secular equation ||p(sig)|| = radius, p(sig) = -b / (lam + sig)
    sig_lb = torch.clamp(-lam1, min=0.0)
    tiny = eps * scale * 16.0

    def w2(sig):
        d = lam + sig[:, None]
        d = torch.where(torch.abs(d) < es, es.expand_as(d), d)
        return torch.sum((b / d) ** 2, dim=-1)

    # hard case: the step is still short at the interval's left end
    hard = (~interior_ok) & (w2(sig_lb + tiny) < radius**2)

    # ---- safeguarded Newton on phi(sig) = 1/||p(sig)|| - 1/radius
    sig = sig_lb + torch.linalg.vector_norm(b, dim=-1) / radius + tiny
    fmin = torch.finfo(dtype).tiny
    for _ in range(newton_iters):
        d = lam + sig[:, None]
        d = torch.where(d < es, es.expand_as(d), d)
        w = torch.clamp(torch.sqrt(torch.sum((b / d) ** 2, dim=-1)), min=fmin)
        phi = 1.0 / w - 1.0 / radius
        dphi = torch.sum(b**2 / d**3, dim=-1) / w**3
        step = phi / torch.where(dphi == 0, torch.ones_like(dphi), dphi)
        sig = torch.maximum(sig - step, sig_lb + tiny)
    d = lam + sig[:, None]
    p_bnd = -b / torch.where(d < es, es.expand_as(d), d)

    # ---- hard case: sig = -lam1; the regular part plus the eigenvector of lam1
    min_mask = torch.abs(lam - lam1[:, None]) <= 16.0 * es
    d_h = torch.where(min_mask, torch.ones_like(lam), lam - lam1[:, None])
    p_reg = torch.where(min_mask, torch.zeros_like(b), -b / d_h)
    alpha2 = torch.clamp(radius**2 - _dot(p_reg, p_reg), min=0.0)
    p_hard = p_reg.clone()
    p_hard[:, 0] += torch.sqrt(alpha2)  # e1: q1's eigenbasis coordinates

    p_c = torch.where(interior_ok[:, None], p_int_c,
                      torch.where(hard[:, None], p_hard, p_bnd))
    zero = torch.zeros_like(sig)
    lam_out = torch.where(interior_ok, zero, torch.where(hard, -lam1, sig))
    code = torch.where(interior_ok, 0, torch.where(hard, 2, 1))
    return _mv(Q, p_c), lam_out, code, p_c


def _cho_solve(l, rhs):
    return torch.cholesky_solve(rhs[..., None], l)[..., 0]


def solve_trs_ms(A, a, radius, *, lanczos_iters=32, newton_iters=48, inv_iters=6,
                 lam_est=None):
    """Global TRS solution by safeguarded Moré-Sorensen iteration.

    1. lambda extremes by dense Lanczos (or ``lam_est`` = (lam_min, lam_max)
       [B] each, e.g. RIPTRM's exact-mode cache); decisions about definiteness
       are certified by Cholesky success, never assumed from the estimate;
    2. interior candidate: A factors at shift 0 and ||A^{-1} a|| <= radius;
    3. otherwise safeguarded Newton on 1/||p(sig)|| - 1/radius, one
       factorisation and two triangular solves per iteration; a failed
       factorisation raises the bracket's lower edge;
    4. hard case (no root above -lambda_1): the boundary completion along an
       inverse-iteration eigenvector of lambda_1.

    Returns (p, lam, code, mineig_est)."""
    dtype, dev = A.dtype, A.device
    bsz, n = a.shape
    radius = torch.broadcast_to(torch.as_tensor(radius, dtype=dtype, device=dev), (bsz,))
    eps = torch.finfo(dtype).eps
    fmin = torch.finfo(dtype).tiny
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=1.0)
    norm_a = torch.linalg.vector_norm(a, dim=-1)
    eye = torch.eye(n, dtype=dtype, device=dev)
    ones = torch.full((bsz, n), 1.0, dtype=dtype, device=dev) / torch.sqrt(
        torch.tensor(float(n), dtype=dtype, device=dev))

    # ---- Lanczos extremes; the start mixes a with a fixed direction, so a
    # gradient orthogonal to the lambda_1 eigenvector cannot deflate it away
    if lam_est is None:
        ramp = torch.linspace(0.5, 1.5, n, dtype=dtype, device=dev)
        mix = ones + 1e-3 * ramp
        v0 = torch.where((norm_a > eps * scale)[:, None],
                         a / torch.clamp(norm_a, min=eps)[:, None] + 0.05 * mix, mix)
        v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
        _, _, ritz = lanczos(lambda v: _mv(A, v), v0, _dot, min(lanczos_iters, n))
        lam_min_est, lam_max_est = ritz[:, 0], ritz[:, -1]
    else:
        lam_min_est, lam_max_est = lam_est

    # ---- interior candidate, certified by Cholesky success at shift 0
    l0, info0 = torch.linalg.cholesky_ex(A)
    pd0 = info0 == 0
    safe_l0 = torch.where(pd0[:, None, None], l0, eye)
    p_int = torch.where(pd0[:, None], _cho_solve(safe_l0, -a), torch.zeros_like(a))
    interior_ok = pd0 & (_dot(p_int, p_int) <= radius**2)

    # ---- the Newton bracket: sigma* in [max(0, -lam_1), ||a||/radius - lam_1]
    slack = 16.0 * eps * scale + 1e-3 * torch.abs(lam_min_est)
    ratio = norm_a / torch.clamp(radius, min=eps)
    lo = torch.clamp(-lam_min_est, min=0.0)  # may lie below the true -lam_1
    hi = torch.maximum(ratio - lam_min_est + slack, lo + slack)
    # start inside [||a||/radius - lam_max, ||a||/radius - lam_min]
    sig = torch.minimum(torch.maximum(ratio - lam_max_est, lo + slack), hi - slack)
    sig_p = sig.clone()  # the sigma that p belongs to
    p = torch.zeros_like(a)
    np_ = torch.zeros_like(norm_a)
    ok_any = torch.zeros_like(pd0)
    rtol = max(32.0 * eps, 1e-11)

    def lanes_on(sig, sig_p, p, np_, ok_any, lo, hi):
        done = ok_any & (torch.abs(np_ - radius) <= rtol * radius)
        return (~interior_ok) & (~done)

    def newton(_, sig, sig_p, p, np_, ok_any, lo, hi):
        run = lanes_on(sig, sig_p, p, np_, ok_any, lo, hi)
        l, info = torch.linalg.cholesky_ex(A + sig[:, None, None] * eye)
        finite = info == 0
        safe_l = torch.where(finite[:, None, None], l, eye)
        p_try = _cho_solve(safe_l, -a)
        np_try = torch.linalg.vector_norm(p_try, dim=-1)
        # q = U^{-1} p with the upper factor U = L' (the JAX function's
        # ``cho_factor`` default), the Newton step's ||q||^2 as there
        qv = torch.linalg.solve_triangular(safe_l.mT, p_try[..., None], upper=True)[..., 0]
        nq2 = torch.clamp(_dot(qv, qv), min=fmin)
        dsig = (np_try**2 / nq2) * (np_try - radius) / torch.clamp(radius, min=eps)
        # a failed factor or ||p|| > radius: sigma too small
        lo_new = torch.where(~finite | (np_try > radius), torch.maximum(lo, sig), lo)
        hi_new = torch.where(finite & (np_try <= radius), torch.minimum(hi, sig), hi)
        sig_newton = sig + torch.where(finite, dsig, torch.zeros_like(dsig))
        # inclusive bracket, and tiny steps pass: at convergence the
        # bracket's edge is the iterate
        inside = (sig_newton >= lo_new) & (sig_newton <= hi_new)
        tiny_step = torch.abs(dsig) <= 64.0 * eps * (torch.abs(sig) + 1.0)
        sig_next = torch.where(finite & (inside | tiny_step), sig_newton,
                               0.5 * (lo_new + hi_new))
        # a lane that has stopped keeps its values
        upd = run
        sig_p = torch.where(upd & finite, sig, sig_p)
        p = torch.where((upd & finite)[:, None], p_try, p)
        np_ = torch.where(upd & finite, np_try, np_)
        ok_any = ok_any | (upd & finite)
        sig = torch.where(upd, sig_next, sig)
        lo = torch.where(upd, lo_new, lo)
        hi = torch.where(upd, hi_new, hi)
        return sig, sig_p, p, np_, ok_any, lo, hi

    sig, sig_p, p, np_, ok_any, lo, hi = lane_loop(
        lambda *c: lanes_on(*c).any(), newton, (sig, sig_p, p, np_, ok_any, lo, hi),
        newton_iters)
    p_bnd = p

    # ---- hard case: converged onto the bracket's lower edge with the step
    # still inside; complete to the boundary along the lambda_1 eigenvector
    hard = (~interior_ok) & ok_any & (np_ < (1.0 - 1e-4) * radius)
    p_hard = p_bnd
    if tracing() or bool(hard.any()):  # per-lane select: every lane under tracing
        l_h, info_h = torch.linalg.cholesky_ex(A + (sig_p + slack)[:, None, None] * eye)
        safe_h = torch.where((info_h == 0)[:, None, None], l_h, eye)
        v_min = ones
        for _ in range(inv_iters):
            w = _cho_solve(safe_h, v_min)
            v_min = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1), min=fmin)[:, None]
        # ||p + tau v|| = radius; the root with the smaller model value
        pv = _dot(p_bnd, v_min)
        disc = torch.clamp(pv**2 + radius**2 - np_**2, min=0.0)
        tau = torch.where(pv > 0, -pv - torch.sqrt(disc), -pv + torch.sqrt(disc))
        p_hard = torch.where(hard[:, None], p_bnd + tau[:, None] * v_min, p_bnd)

    x = torch.where(interior_ok[:, None], p_int, torch.where(hard[:, None], p_hard, p_bnd))
    lam_out = torch.where(interior_ok, torch.zeros_like(sig_p), sig_p)
    code = torch.where(interior_ok, 0, torch.where(hard, 2, 1))
    return x, lam_out, code, lam_min_est

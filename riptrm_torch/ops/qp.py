"""Dense convex QP solver (primal-dual Mehrotra predictor-corrector), over
lanes.

Counterpart of ``riptrm_tpu/ops/qp.py``; every lane solves

    minimize    0.5 d'Q d + p'd
    subject to  G d <= h,   A d = b

with Q symmetric positive definite (RSQO regularises it first).  The JAX
``while_loop`` of the IPM is a lane-masked ``utils/lanes.py::lane_loop``
here (eagerly one host check of "any lane running" an iteration): a lane that has converged,
stalled or used its ``maxiter`` keeps its values exactly, while the others
go on.  The Newton-Schulz sweeps of ``method='schulz'`` are lane-masked
loops inside it.  ``torch.linalg.cholesky_ex`` and ``lu_factor_ex`` report
a failed factorisation per lane (``info != 0``) without raising or a host
sync: the factor is set to NaN there, which is what the JAX factorisation
returns, so the lane's step is non-finite and the lane freezes at its last
finite iterate (status 2).  The solver never switches ``method``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from riptrm_torch.utils.lanes import bcast as _bc
from riptrm_torch.utils.lanes import dot as _dot
from riptrm_torch.utils.lanes import lane_loop
from riptrm_torch.utils.lanes import mv as _mv

# Newton-Schulz inverse maintenance (method='schulz'): refresh until
# ||M X - I||_F <= TOL, at most MAX updates (WARM_MAX for a carried
# inverse, which then fails fast to the scaled identity); an inverse is
# usable only at err <= sqrt(TOL).  The JAX package's constants.
_SCHULZ_TOL = 0.1
_SCHULZ_MAX = 64
_SCHULZ_WARM_MAX = 8
_SCHULZ_USABLE = 0.31622776601  # sqrt(_SCHULZ_TOL)

METHODS = ("chol", "lu", "schulz", "schulz_polish")


@dataclasses.dataclass
class QpResult:
    x: torch.Tensor  # [B, n]
    z: torch.Tensor  # inequality multipliers (>= 0), [B, m]
    y: torch.Tensor  # equality multipliers, [B, l]
    s: torch.Tensor  # slacks (>= 0), [B, m]
    iterations: torch.Tensor  # [B]
    gap: torch.Tensor
    primal_infeasibility: torch.Tensor
    dual_infeasibility: torch.Tensor
    status: torch.Tensor  # 0 = optimal, 1 = max-iter, 2 = frozen at a non-finite step
    xinv: Optional[torch.Tensor] = None  # method='schulz': warm start of the next QP


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _nan_where(info, a):
    """NaN on the lanes whose factorisation failed (``info != 0``)."""
    return torch.where(_bc(info != 0, a), torch.full_like(a, float("nan")), a)


def _all_finite(a):
    return torch.isfinite(a.reshape(a.shape[0], -1)).all(dim=-1)


def solve_qp(Q, p, G, h, A=None, b=None, *, abstol=1e-10, reltol=1e-10,
             feastol=1e-10, maxiter=50, warm_z=None, method="chol", xinv0=None):
    """Solve the QP on every lane: Q [B, n, n], p [B, n], G [B, m, n],
    h [B, m], A [B, l, n] and b [B, l] (``A``/``b`` may be None or l = 0).

    ``method``: 'chol' factors the condensed SPD Newton matrix
    M = Q + G' diag(z/s) G once per IPM iteration (equalities through the
    SPD Schur complement A M^-1 A'); 'lu' factors M, or the saddle block
    [M, A'; A, 0] when A is not empty, by partial-pivot LU; 'schulz'
    (inequality-only) maintains X ~= M^-1 by Newton-Schulz iteration across
    IPM iterations and solves by X with two Richardson sweeps, warm-started
    from ``xinv0`` [B, n, n] (all zero: cold); 'schulz_polish' follows the
    schulz loop with up to 3 LU iterations.  ``warm_z`` [B, m] warm-starts
    the inequality multipliers.  An indefinite Q gives NaN steps: the lane
    freezes with status 2, nothing raises."""
    if method not in METHODS:
        raise ValueError(f"solve_qp method {method!r}: one of {METHODS}")
    dtype, dev = Q.dtype, Q.device
    lanes, n, m = Q.shape[0], Q.shape[-1], G.shape[1]
    if A is None:
        A = torch.zeros((lanes, 0, n), dtype=dtype, device=dev)
        b = torch.zeros((lanes, 0), dtype=dtype, device=dev)
    l = A.shape[1]
    use_polish = method == "schulz_polish"
    use_schulz = method == "schulz" or use_polish
    if use_schulz and l > 0:
        raise ValueError(
            "method='schulz' supports inequality-only QPs (A must be empty);"
            " use 'chol' or 'lu' when equality constraints are present"
        )
    m_div = max(m, 1)  # m == 0: equality-only QP, mu := 0
    eye_n = torch.eye(n, dtype=dtype, device=dev) if use_schulz else None
    Gt, At = G.mT, A.mT

    scale = torch.clamp(_norm(h) / m_div, min=1.0)
    x0 = torch.zeros((lanes, n), dtype=dtype, device=dev)
    y0 = torch.zeros((lanes, l), dtype=dtype, device=dev)
    if warm_z is None:
        # cold start: s = scale, z = 1 (infeasible-start IPM)
        s0 = scale[:, None].expand(lanes, m).clone()
        z0 = torch.ones((lanes, m), dtype=dtype, device=dev)
    else:
        # warm start at x = 0: s = h zeroes the primal residual where h >= 0
        s0 = torch.maximum(h, 1e-2 * scale[:, None])
        z0 = torch.clamp(warm_z.to(dtype), min=1e-4)

    def residuals(x, s, z, y):
        rd = _mv(Q, x) + p + _mv(Gt, z) + _mv(At, y)
        rp = _mv(G, x) + s - h
        re = _mv(A, x) - b
        return rd, rp, re

    hb_norm = torch.clamp(_norm(torch.cat([h, b], dim=-1)), min=1.0)
    p_norm = torch.clamp(_norm(p), min=1.0)

    def converged(x, s, z, y):
        rd, rp, re = residuals(x, s, z, y)
        gap = _dot(s, z)
        pcost = _dot(torch.einsum("bi,bij->bj", 0.5 * x, Q), x) + _dot(p, x)
        pr_inf = _norm(torch.cat([rp, re], dim=-1)) / hb_norm
        du_inf = _norm(rd) / p_norm
        rel_ok = gap <= reltol * torch.clamp(torch.abs(pcost), min=1.0)
        return (pr_inf <= feastol) & (du_inf <= feastol) & ((gap <= abstol) | rel_ok)

    def build_m(s, z):
        return Q + (Gt * (z / s)[:, None, :]) @ G

    def row_sum_inv(M):
        return 1.0 / torch.clamp(torch.amax(torch.sum(torch.abs(M), dim=-1), dim=-1),
                                 min=1e-30)

    def schulz_sweep(X, M, err, max_iter, active):
        """Newton-Schulz on the active lanes until ||M X - I||_F <= TOL (err
        measured before each update), at most max_iter updates."""
        k = torch.zeros(lanes, dtype=torch.int64, device=dev)

        def running(X, err, k):
            return (active & (err > _SCHULZ_TOL) & (k < max_iter)).any()

        def update(_, X, err, k):
            run = active & (err > _SCHULZ_TOL) & (k < max_iter)
            P = M @ X
            e = torch.linalg.matrix_norm(P - eye_n)
            Xn = X @ (2.0 * eye_n - P)
            Xn = 0.5 * (Xn + Xn.mT)
            X = torch.where(_bc(run, X), Xn, X)
            err = torch.where(run, e, err)
            return X, err, k + run.to(k.dtype)

        X, err, _ = lane_loop(running, update, (X, err, k))
        return X, err

    def schulz_refresh(X, M, active):
        """A warm sweep of WARM_MAX updates; on divergence the scaled
        identity, then up to MAX updates.  Returns (X, err)."""
        inf0 = torch.full((lanes,), float("inf"), dtype=dtype, device=dev)
        X1, e1 = schulz_sweep(X, M, inf0, _SCHULZ_WARM_MAX, active)
        bad = ~torch.isfinite(e1) | (e1 > 1.0) | ~_all_finite(X1)
        cold = row_sum_inv(M)[:, None, None] * eye_n
        return schulz_sweep(torch.where(_bc(bad, X1), cold, X1), M,
                            torch.where(bad, inf0, e1), _SCHULZ_MAX, active)

    def kkt_factor(s, z, kind):
        M = build_m(s, z)
        if kind == "lu":
            if l > 0:
                K = torch.cat([
                    torch.cat([M, At], dim=-1),
                    torch.cat([A, torch.zeros((lanes, l, l), dtype=dtype, device=dev)], dim=-1),
                ], dim=-2)
            else:
                K = M
            lu, piv, info = torch.linalg.lu_factor_ex(K)
            return _nan_where(info, lu), piv, None
        L, info = torch.linalg.cholesky_ex(M)
        L = _nan_where(info, L)
        if l > 0:
            minv_at = torch.cholesky_solve(At, L)  # [B, n, l]
            Ls, info_s = torch.linalg.cholesky_ex(A @ minv_at)
            return L, minv_at, _nan_where(info_s, Ls)
        return L, None, None

    def kkt_solve(fact, s, z, rd, rp, re, rc, kind):
        """One right-hand side through the shared factorisation:
        [Q + G'WG, A'; A, 0] [dx; dy] = [-rd - G'((z rp - rc)/s); -re]."""
        f0, f1, f2 = fact
        rhs_x = -rd - _mv(Gt, (z * rp - rc) / s)
        dy = torch.zeros((lanes, 0), dtype=dtype, device=dev)
        if kind == "schulz":
            X, M = f0, f1
            dx = _mv(X, rhs_x)
            dx = dx + _mv(X, rhs_x - _mv(M, dx))
            dx = dx + _mv(X, rhs_x - _mv(M, dx))
        elif kind == "lu":
            if l > 0:
                sol = torch.linalg.lu_solve(f0, f1, torch.cat([rhs_x, -re], dim=-1)[..., None])[..., 0]
                dx, dy = sol[:, :n], sol[:, n:]
            else:
                dx = torch.linalg.lu_solve(f0, f1, rhs_x[..., None])[..., 0]
        elif l > 0:
            minv_rhs = torch.cholesky_solve(rhs_x[..., None], f0)[..., 0]
            dy = torch.cholesky_solve((_mv(A, minv_rhs) + re)[..., None], f2)[..., 0]
            dx = minv_rhs - _mv(f1, dy)
        else:
            dx = torch.cholesky_solve(rhs_x[..., None], f0)[..., 0]
        ds = -(rp + _mv(G, dx))
        dz = -(rc + z * ds) / s
        return dx, ds, dz, dy

    def max_step(v, dv):
        """Largest alpha in (0, 1] keeping v + alpha dv > 0, per lane."""
        if v.shape[-1] == 0:
            return torch.ones(lanes, dtype=dtype, device=dev)
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                            torch.full_like(v, float("inf")))
        return torch.clamp(0.99 * torch.amin(ratio, dim=-1), max=1.0)

    def body(st, kind, active):
        x, s, z, y = st["x"], st["s"], st["z"], st["y"]
        rd, rp, re = residuals(x, s, z, y)
        mu = _dot(s, z) / m_div
        if kind == "schulz":
            M = build_m(s, z)
            Xr, schulz_err = schulz_refresh(st["X"], M, active)
            fact = (Xr, M, None)
        else:
            fact = kkt_factor(s, z, kind)

        # affine (predictor) step
        dx_a, ds_a, dz_a, _ = kkt_solve(fact, s, z, rd, rp, re, z * s, kind)
        alpha_a = torch.minimum(max_step(s, ds_a), max_step(z, dz_a))
        mu_aff = _dot(s + alpha_a[:, None] * ds_a, z + alpha_a[:, None] * dz_a) / m_div
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0)

        # corrector step (same factorisation, new right-hand side)
        rc = z * s + ds_a * dz_a - (sigma * mu)[:, None]
        dx, ds, dz, dy = kkt_solve(fact, s, z, rd, rp, re, rc, kind)
        alpha = torch.minimum(max_step(s, ds), max_step(z, dz))[:, None]
        new = {"x": x + alpha * dx, "s": s + alpha * ds, "z": z + alpha * dz,
               "y": y + alpha * dy}
        # freeze a lane at its last finite iterate (a failed factorisation,
        # or a Newton-Schulz inverse that is no longer usable)
        ok = _all_finite(new["x"]) & _all_finite(new["s"]) & _all_finite(new["z"]) \
            & _all_finite(new["y"])
        if kind == "schulz":
            ok = ok & (schulz_err <= _SCHULZ_USABLE)
        out = {k: torch.where(_bc(ok, v), v, st[k]) for k, v in new.items()}
        out["stalled"] = st["stalled"] | ~ok
        if kind == "schulz":
            out["X"] = torch.where(_bc(ok, Xr), Xr, st["X"])
            out["Xf"] = torch.where(_bc((st["k"] == 0) & ok, Xr), out["X"], st["Xf"])
        else:
            out["X"], out["Xf"] = st["X"], st["Xf"]
        out["k"] = st["k"] + 1
        out["done"] = converged(out["x"], out["s"], out["z"], out["y"]) | ~ok
        return out

    def run(st, kind, limit):
        def running(st):
            return ((~st["done"]) & (st["k"] < limit)).any()

        def iterate(_, st):
            active = (~st["done"]) & (st["k"] < limit)
            new = body(st, kind, active)
            return ({k: torch.where(_bc(active, v), new[k], v) for k, v in st.items()},)

        return lane_loop(running, iterate, (st,))[0]

    if use_schulz:
        M0 = build_m(s0, z0)
        cold = row_sum_inv(M0)[:, None, None] * eye_n
        if xinv0 is None:
            X_init = cold
        else:
            xw = xinv0.to(dtype)
            usable = _all_finite(xw) & (torch.sum(xw * xw, dim=(-2, -1)) > 0)
            X_init = torch.where(_bc(usable, xw), xw, cold)
        Xf_init = torch.zeros((lanes, n, n), dtype=dtype, device=dev)
    else:
        X_init = Xf_init = torch.zeros((lanes, 0, 0), dtype=dtype, device=dev)

    st = {"x": x0, "s": s0, "z": z0, "y": y0,
          "k": torch.zeros(lanes, dtype=torch.int64, device=dev),
          "done": converged(x0, s0, z0, y0),
          "stalled": torch.zeros(lanes, dtype=torch.bool, device=dev),
          "X": X_init, "Xf": Xf_init}
    st = run(st, "schulz" if use_schulz else method, maxiter)
    if use_polish:
        # up to 3 exact LU iterations from the schulz endpoint; a lane the
        # schulz loop froze (status 2) resumes here from its finite iterate
        st["done"] = converged(st["x"], st["s"], st["z"], st["y"])
        st["stalled"] = torch.zeros_like(st["stalled"])
        st = run(st, "lu", st["k"] + 3)
    rd, rp, re = residuals(st["x"], st["s"], st["z"], st["y"])
    status = torch.where(st["stalled"], 2, torch.where(st["done"], 0, 1))
    return QpResult(
        x=st["x"], z=st["z"], y=st["y"], s=st["s"], iterations=st["k"],
        gap=_dot(st["s"], st["z"]),
        primal_infeasibility=_norm(torch.cat([rp, re], dim=-1)),
        dual_infeasibility=_norm(rd),
        status=status,
        xinv=st["Xf"] if use_schulz else None,
    )

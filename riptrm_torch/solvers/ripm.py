"""RIPM: Riemannian primal-dual Interior Point Method (Lai-Yoshise baseline).

Counterpart of ``riptrm_tpu/solvers/ripm.py``, over lanes: the state
carries ``x`` [B, ...], the equality multipliers ``y`` [B, l], the
inequality multipliers ``z`` and slacks ``s`` [B, m] and per-lane scalars
[B]; one step serves the host runner (``RIPM.run``, B = 1) and the
fixed-budget loop (``solve_compiled``, any B; ``parallel/sweep.py``).

The Newton direction comes from one of three solves, as in the JAX step:
the condensed saddle system materialised in the tangent basis and solved
densely (``ops/kernels.py::dense_solve_nan``: the hand-written batched LU
for float32 systems up to n = 64, ``torch.linalg.solve_ex`` for the rest;
a singular lane reads NaN, as XLA's solve gives it, and the
singular-Newton guard freezes it), the matrix-free
conjugate residual on T_x M x R^l (``ops/conjres.py``), or that CR in
basis coordinates with the Jacobi preconditioner ``jacobi_theta``.  The
merit line search is a lane-masked loop, a lane that has found its step
frozen while the others backtrack.  ``checkNTequation``'s eigenvalues of
the non-symmetric covariant derivative are computed by numpy on the host,
per lane (a debug path).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from riptrm_torch.ops.basis import constraint_grad_rows, materialize_symmetrized
from riptrm_torch.ops.conjres import conjugate_residual
from riptrm_torch.ops.kernels import dense_solve_nan
from riptrm_torch.ops.kkt import compute_residual, evaluation
from riptrm_torch.solvers import base
from riptrm_torch.solvers.base import (
    Output,
    compiled_best_while,
    host_run,
    max_abs_multiplier,
    maybe_wandb_finish,
    maybe_wandb_init,
    merge_options,
)
from riptrm_torch.utils.lanes import bcast as _bc
from riptrm_torch.utils.lanes import dot as _dot
from riptrm_torch.utils.lanes import lane_loop
from riptrm_torch.utils.lanes import where_lanes as _lanes
from riptrm_torch.utils.spans import span


def default_option():
    """The JAX package's defaults (``riptrm_tpu/solvers/ripm.py``)."""
    return {
        "maxtime": 100,
        "maxiter": 100,
        "tolresid": 1e-6,
        "KrylovIterMethod": False,
        "KrylovTolrelresid": 1e-9,
        "KrylovMaxIteration": 1000,
        # 'jacobi_theta': CR in basis coordinates, symmetrically scaled by
        # the exact diagonal of Theta-hat plus a Rayleigh estimate of the
        # Lagrangian Hessian (inequality-only problems)
        "KrylovPreconditioner": "none",
        # fixed-budget loops only: return the best-residual iterate
        "keep_best_point": False,
        "checkNTequation": False,
        "gamma": 0.9,
        "linesearch_execute_fun2": False,
        "linesearch_beta": 1e-4,
        "linesearch_theta": 0.5,
        "linesearch_max_steps": 50,
        "heuristic_z_s": False,
        "desired_tau_1": 0.5,
        "important": 1.0,
        "verbosity": 0,
        "wandb_logging": False,
        "do_exit_on_error": True,
    }


@dataclasses.dataclass
class RipmState:
    x: torch.Tensor
    y: torch.Tensor  # equality multipliers [B, l]
    z: torch.Tensor  # inequality multipliers [B, m]
    s: torch.Tensor  # slacks [B, m]
    phi: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    gamma: torch.Tensor
    iteration: torch.Tensor  # int64


def state_from_numpy(d, device=None, dtype=None, manifold=None) -> RipmState:
    """Port's state from a dict of arrays (e.g. a JAX ``RipmState``'s
    ``_asdict()``), one lane or [B] lanes (``base.state_from_numpy``)."""
    return base.state_from_numpy(RipmState, d, scalar_field="phi",
                                 int_fields=("iteration",), device=device, dtype=dtype,
                                 manifold=manifold)


state_to_numpy = base.state_to_numpy


def _kkt_field(problem, x, y, z, s):
    """F(w) = (grad_x L, h(x), g(x) + s, z * s)."""
    fx = problem.lag_rgrad(x, z, y)
    fy = problem.eq_val(x)
    fz = problem.ineq_val(x) + s
    fs = z * s
    return fx, fy, fz, fs


def _phi(problem, x, fx, fy, fz, fs):
    return problem.manifold.inner(x, fx, fx) + _dot(fy, fy) + _dot(fz, fz) + _dot(fs, fs)


def _constraint_grad_matrix(problem, x, basis, m):
    """G [B, m, dim] with G[b, i, :] = coords of rgrad g_i at x[b]: one
    vmapped vjp (RIPM's barGx uses +grad g)."""
    return constraint_grad_rows(problem.manifold, x, basis, problem.ineq_fn, m)


def _eq_grad_matrix(problem, x, basis, l):
    return constraint_grad_rows(problem.manifold, x, basis, problem.eq_fn, l)


def _check_slice(option):
    if option["KrylovPreconditioner"] not in ("none", "jacobi_theta"):
        raise ValueError(f"KrylovPreconditioner {option['KrylovPreconditioner']!r}")


def make_step(problem, option):
    """Build ``step(state, tau_1, tau_2) -> (state, info)``; ``tau_1`` and
    ``tau_2`` are [B], ``info`` a dict of [B] tensors with the JAX step's
    keys."""
    _check_slice(option)
    man = problem.manifold
    dim = man.dim
    m = problem.num_ineq
    l = problem.num_eq
    krylov = option["KrylovIterMethod"]
    check_nt = option["checkNTequation"]
    precon = krylov and option["KrylovPreconditioner"] == "jacobi_theta"
    if precon and l > 0:
        raise NotImplementedError(
            "KrylovPreconditioner='jacobi_theta' supports inequality-only problems "
            "(the equality block would make the coordinate system indefinite-saddle)"
        )

    def step(state: RipmState, tau_1, tau_2):
        x, y, z, s = state.x, state.y, state.z, state.s
        sigma, rho, gamma = state.sigma, state.rho, state.gamma
        lanes, dt, dev = s.shape[0], s.dtype, s.device
        with span("riptrm.ripm.kkt"):
            fx, fy, fz, fs = _kkt_field(problem, x, y, z, s)
            phi_cur = _phi(problem, x, fx, fy, fz, fs)
            sr = (sigma * rho)[:, None]  # sigma * rho * ehat

            # point-frozen operators
            lag_hvp = problem.lag_rhess_at(x, z, y)
            gx_neg = problem.gx_at(x)
            gx_pos = lambda v: gx_neg(-v)  # RIPM's barGx uses +grad g
            gxaj_pos = lambda dx: -problem.gx_adj(x, dx)

            # condensed Newton right-hand side
            c = -fx - gx_pos((z * fz + sr - fs) / s)
            q = -fy

        def op_aw(dx):
            return lag_hvp(dx) + gx_pos(gxaj_pos(dx) * (z / s))

        empty_y = torch.zeros((lanes, 0), dtype=dt, device=dev)
        basis = None
        if not krylov:
            # dense saddle solve in coordinates
            with span("riptrm.ripm.materialize"):
                basis = man.basis(x)
                aw_mat = materialize_symmetrized(man, x, basis, op_aw)
                c_vec = man.to_coords(x, basis, c)
                if l > 0:
                    heq = _eq_grad_matrix(problem, x, basis, l)  # [B, l, dim]
        with span("riptrm.ripm.krylov" if krylov else "riptrm.ripm.newton_solve"):
            if krylov and (check_nt or precon):
                basis = man.basis(x)
            if precon:
                # CR on the symmetrically Jacobi-scaled operator in
                # metric-orthonormal coordinates, D = diag(Theta-hat) + the
                # Hessian's Rayleigh scale, its spread capped
                g_mat = _constraint_grad_matrix(problem, x, basis, m)  # [B, m, dim]
                theta_diag = torch.einsum("bk,bki->bi", z / s, g_mat * g_mat)
                c_hat = man.to_coords(x, basis, c)
                hess_c = lag_hvp(c)
                cc = man.inner(x, c, c)
                rayleigh = torch.abs(man.inner(x, c, hess_c)) / torch.clamp(
                    cc, min=torch.finfo(dt).tiny)
                d_raw = theta_diag + torch.clamp(rayleigh, min=1e-8)[:, None]
                kappa_cap = option.get("KrylovPreconKappaCap", 1e8)
                d_scale = torch.maximum(d_raw, (torch.amax(d_raw, dim=-1) / kappa_cap)[:, None])
                d_isqrt = torch.rsqrt(d_scale)
                d_sqrt = torch.sqrt(d_scale)

                def op_hat(u):
                    v = man.from_coords(x, basis, d_isqrt * u[0])
                    return (d_isqrt * man.to_coords(x, basis, op_aw(v)),)

                (sol,), krylov_iters, krylov_relres = conjugate_residual(
                    lambda u, v: _dot(u[0], v[0]),
                    op_hat,
                    (d_isqrt * c_hat,),
                    (torch.zeros((lanes, dim), dtype=dt, device=dev),),
                    tol=option["KrylovTolrelresid"],
                    maxiter=option["KrylovMaxIteration"],
                    # stop on the original system's residual norm
                    stop_norm=lambda r: torch.linalg.vector_norm(d_sqrt * r[0], dim=-1),
                )
                ntdir_x = man.from_coords(x, basis, d_isqrt * sol)
                ntdir_y = empty_y
            elif krylov:
                # matrix-free conjugate residual on T_x M x R^l
                hx = problem.hx_at(x) if l > 0 else None
                inner_x = man.inner_at(x)

                def op_t(dxdy):
                    dx, dy = dxdy
                    out_x = op_aw(dx)
                    if l > 0:
                        return out_x + hx(dy), problem.hx_adj(x, dx)
                    return out_x, empty_y

                (ntdir_x, ntdir_y), krylov_iters, krylov_relres = conjugate_residual(
                    lambda u, v: inner_x(u[0], v[0]) + _dot(u[1], v[1]),
                    op_t,
                    (c, q),
                    (man.zero_vector(x), torch.zeros((lanes, l), dtype=dt, device=dev)),
                    tol=option["KrylovTolrelresid"],
                    maxiter=option["KrylovMaxIteration"],
                )
            elif l > 0:
                t_mat = torch.cat([
                    torch.cat([aw_mat, heq.mT], dim=-1),
                    torch.cat([heq, torch.zeros((lanes, l, l), dtype=dt, device=dev)], dim=-1),
                ], dim=-2)
                sol = dense_solve_nan(t_mat, torch.cat([c_vec, q], dim=-1))
                ntdir_x = man.from_coords(x, basis, sol[:, :dim])
                ntdir_y = sol[:, dim:]
            else:
                sol = dense_solve_nan(aw_mat, c_vec)
                ntdir_x = man.from_coords(x, basis, sol)
                ntdir_y = empty_y

            # recover dz, ds
            gxaj_dx = gxaj_pos(ntdir_x)
            ntdir_z = (z * (gxaj_dx + fz) + sr - fs) / s
            ntdir_s = (sr - fs - s * ntdir_z) / z

            norm_ntdir_x = man.norm(x, ntdir_x)
            norm_ntdir_w = torch.sqrt(
                norm_ntdir_x**2 + _dot(ntdir_y, ntdir_y) + _dot(ntdir_z, ntdir_z)
                + _dot(ntdir_s, ntdir_s)
            )
            gradf_ntdir = man.inner(x, problem.rgrad(x), ntdir_x)

        nt_info = {}
        if check_nt:
            nt_info = _check_nt_equation(
                problem, x, y, z, s, basis, (ntdir_x, ntdir_y, ntdir_z, ntdir_s),
                (fx, fy, fz, fs), phi_cur, sigma, rho,
            )

        with span("riptrm.ripm.line_search"):
            ls_right = 2.0 * (sigma * rho * _dot(z, s) - phi_cur)
            stepsize, w_new, phi_new, r = _merit_line_search(
                problem, option, (x, y, z, s), (ntdir_x, ntdir_y, ntdir_z, ntdir_s), phi_cur,
                ls_right, gamma, tau_1, tau_2)
        ls_status = r <= option["linesearch_max_steps"]

        x_new, y_new, z_new, s_new = w_new
        sigma_new = torch.clamp(phi_new**0.25, max=0.5)
        rho_new = _dot(z_new, s_new) / m
        gamma_new = 0.5 * (gamma + 0.5)

        # singular-Newton guard: a non-finite direction (a singular dense
        # solve reads NaN) freezes the lane and flags it
        dir_finite = torch.isfinite(norm_ntdir_w) & torch.isfinite(phi_new)
        new_state = RipmState(
            x=_lanes(dir_finite, x_new, x),
            y=_lanes(dir_finite, y_new, y),
            z=_lanes(dir_finite, z_new, z),
            s=_lanes(dir_finite, s_new, s),
            phi=torch.where(dir_finite, phi_new, phi_cur),
            sigma=torch.where(dir_finite, sigma_new, sigma),
            rho=torch.where(dir_finite, rho_new, rho),
            gamma=torch.where(dir_finite, gamma_new, gamma),
            iteration=state.iteration + 1,
        )
        info = {
            "normNTdirx": norm_ntdir_x,
            "normNTdirw": norm_ntdir_w,
            "stepsize": stepsize,
            "linesearch_status": ls_status,
            "linesearch_counter": r,
            "linesearch_RightItem": ls_right,
            "gradfNTdir": gradf_ntdir,
            "singular_newton": ~dir_finite,
        }
        if krylov:
            info["KrylovIterMethod_Iter"] = krylov_iters
            info["KrylovIterMethod_RelRes"] = krylov_relres
        info.update(nt_info)
        return new_state, info

    return step


def _merit_line_search(problem, option, w, ntdir, phi_cur, ls_right, gamma, tau_1, tau_2):
    """Backtracking merit line search with centrality from w = (x, y, z, s)
    along ``ntdir``, lane-masked: a lane that has found its step keeps it
    while the others backtrack.  ``ls_right`` is the Armijo term's slope
    2 (sigma rho z's - phi).  Returns (stepsize, (x, y, z, s) at it, merit
    there, backtracks), each per lane."""
    man = problem.manifold
    m = problem.num_ineq
    x, y, z, s = w
    ntdir_x, ntdir_y, ntdir_z, ntdir_s = ntdir
    ls_beta = option["linesearch_beta"]
    ls_theta = option["linesearch_theta"]
    ls_max = option["linesearch_max_steps"]

    def trial(stepsize):
        with span("riptrm.ripm.ls_trial"):
            x_new = man.retract(x, _bc(stepsize, ntdir_x) * ntdir_x)
            st = stepsize[:, None]
            w_new = (x_new, y + st * ntdir_y, z + st * ntdir_z, s + st * ntdir_s)
            return w_new, _phi(problem, x_new, *_kkt_field(problem, *w_new))

    def ls_ok(stepsize, z_new, s_new, phi_new):
        armijo = phi_new - phi_cur <= ls_beta * stepsize * ls_right
        zs = _dot(z_new, s_new)
        ok = armijo & (torch.amin(z_new * s_new, dim=-1) - gamma * tau_1 * (zs / m) >= 0)
        if option["linesearch_execute_fun2"]:
            ok = ok & (zs - gamma * tau_2 * torch.sqrt(phi_new) >= 0)
        return ok

    stepsize = torch.ones_like(phi_cur)
    w_new, phi_new = trial(stepsize)
    ok = ls_ok(stepsize, w_new[2], w_new[3], phi_new)
    r = torch.zeros(phi_cur.shape, dtype=torch.int64, device=phi_cur.device)

    def running(stepsize, w_new, phi_new, ok, r):
        return ((~ok) & (r <= ls_max)).any()

    def backtrack(_, stepsize, w_new, phi_new, ok, r):
        active = (~ok) & (r <= ls_max)
        step_try = stepsize * ls_theta
        w2, phi2 = trial(step_try)
        ok2 = ls_ok(step_try, w2[2], w2[3], phi2)
        stepsize = torch.where(active, step_try, stepsize)
        w_new = tuple(_lanes(active, a, b) for a, b in zip(w2, w_new))
        phi_new = torch.where(active, phi2, phi_new)
        ok = torch.where(active, ok2, ok)
        return stepsize, w_new, phi_new, ok, r + active.to(r.dtype)

    stepsize, w_new, phi_new, _, r = lane_loop(running, backtrack,
                                               (stepsize, w_new, phi_new, ok, r))
    return stepsize, w_new, phi_new, r


def _check_nt_equation(problem, x, y, z, s, basis, ntdir, f, phi_cur, sigma, rho):
    """Debug-only Newton-system verification, per lane: the residual of the
    non-condensed system, the merit-gradient identity, the direction's norm
    and angle, and the least |eigenvalue| of the covariant-derivative
    matrix (numpy on the host)."""
    man = problem.manifold
    dim = man.dim
    m = problem.num_ineq
    l = problem.num_eq
    lanes, dt, dev = s.shape[0], s.dtype, s.device
    fx, fy, fz, fs = f
    sr = (sigma * rho)[:, None]
    hess_lag = lambda dx: problem.lag_rhess(x, z, dx, y)
    gx_neg = problem.gx_at(x)
    hx = problem.hx_at(x) if l > 0 else None
    empty_y = torch.zeros((lanes, 0), dtype=dt, device=dev)

    def nabla(dw, adjoint):
        dx, dy, dz, ds = dw
        out_x = hess_lag(dx) + gx_neg(-dz)
        if l > 0:
            out_x = out_x + hx(dy)
            out_y = problem.hx_adj(x, dx)
        else:
            out_y = empty_y
        gx_dx = -problem.gx_adj(x, dx)
        if adjoint:
            return out_x, out_y, gx_dx + s * ds, z * ds + dz
        return out_x, out_y, gx_dx + ds, z * ds + s * dz

    def w_inner(u, v):
        return man.inner(x, u[0], v[0]) + _dot(u[1], v[1]) + _dot(u[2], v[2]) + _dot(u[3], v[3])

    def w_norm(u):
        return torch.sqrt(w_inner(u, u))

    rhs = (-fx, -fy, -fz, -fs + sr)
    diff = tuple(a - b for a, b in zip(nabla(ntdir, False), rhs))
    err1 = w_norm(diff)
    gradphi = tuple(2.0 * a for a in nabla((fx, fy, fz, fs), True))
    val = w_inner(gradphi, ntdir)
    err2 = torch.abs(val - 2.0 * (sigma * rho * _dot(z, s) - phi_cur))
    ntdir_norm = w_norm(ntdir)
    angle = -val / (w_norm(gradphi) * ntdir_norm)

    h_mat = materialize_symmetrized(man, x, basis, hess_lag)
    g_mat = _constraint_grad_matrix(problem, x, basis, m)
    heq = (_eq_grad_matrix(problem, x, basis, l) if l > 0
           else torch.zeros((lanes, 0, dim), dtype=dt, device=dev))
    zero = lambda r, c: torch.zeros((lanes, r, c), dtype=dt, device=dev)
    eye_m = torch.eye(m, dtype=dt, device=dev).expand(lanes, m, m)
    full = torch.cat([
        torch.cat([h_mat, heq.mT, g_mat.mT, zero(dim, m)], dim=-1),
        torch.cat([heq, zero(l, l), zero(l, m), zero(l, m)], dim=-1),
        torch.cat([g_mat, zero(m, l), zero(m, m), eye_m], dim=-1),
        torch.cat([zero(m, dim), zero(m, l), torch.diag_embed(s), torch.diag_embed(z)], dim=-1),
    ], dim=-2)
    mineig = []
    for a in full.detach().cpu().numpy():
        w = np.linalg.eigvals(a)
        mineig.append(w[np.argmin(np.abs(w))].real)
    return {
        "NTdir_error1": err1,
        "NTdir_error2": err2,
        "NTdir_norm": ntdir_norm,
        "NTdir_angle": angle,
        "CovDerivKKT_minabseigval": torch.tensor(mineig, dtype=dt, device=dev),
    }


def _centring(z, s, phi, m):
    """(sigma, rho, tau_1, tau_2) of a start (z, s) with merit phi."""
    zs = _dot(z, s)
    return (torch.clamp(phi**0.25, max=0.5), zs / m,
            torch.amin(z * s, dim=-1) * m / zs, zs / torch.sqrt(phi))


def init_state(problem, option):
    """One-lane initial state and (tau_1, tau_2), each [1]."""
    m = problem.num_ineq
    y0 = problem.z0[None]  # equality multipliers
    if option["heuristic_z_s"]:
        z0 = torch.ones((1, m), dtype=y0.dtype, device=y0.device)
        z0[0, 0] = float(np.sqrt((m - 1) / (m / option["desired_tau_1"] - 1)))
        s0 = option["important"] * z0
    else:
        z0 = problem.y0[None]
        s0 = problem.y0[None]
    x0 = problem.x0[None]
    phi0 = _phi(problem, x0, *_kkt_field(problem, x0, y0, z0, s0))
    sigma0, rho0, tau_1, tau_2 = _centring(z0, s0, phi0, m)
    state = RipmState(
        x=x0, y=y0, z=z0, s=s0, phi=phi0, sigma=sigma0, rho=rho0,
        gamma=torch.full((1,), option["gamma"], dtype=z0.dtype, device=z0.device),
        iteration=torch.zeros(1, dtype=torch.int64, device=z0.device),
    )
    return state, tau_1, tau_2


def solve_compiled_best(problem, option, max_steps: int):
    """Fixed-budget solve over the lanes of a state, tracking the best KKT
    residual (the protocol metric, seeded with the initial residual); a
    lane stops once its best <= target, at the residual tolerance, at
    ``maxiter`` or on a singular Newton system.  Returns solve(state,
    tau_1, tau_2, target) -> (state, steps [B], best [B])."""
    option = merge_options(default_option(), option or {})
    step = make_step(problem, option)
    tolresid = option["tolresid"]
    maxiter = option["maxiter"]

    def residual(st):
        return compute_residual(problem, st.x, st.z, st.y)[0]

    def solve(state, tau_1, tau_2, target):
        def step1(st):
            new_st, info = step(st, tau_1, tau_2)
            with span("riptrm.residual"):
                res = residual(new_st)
            stop = (res <= tolresid) | (new_st.iteration >= maxiter) | info["singular_newton"]
            return new_st, res, torch.ones_like(stop), stop

        st, k, _, best = compiled_best_while(
            step1, state, target, max_steps, residual(state),
            stall_window=option.get("sweep_stall_window"),
            track_best_state=option.get("keep_best_point", False),
        )
        return st, k, best

    return solve


def solve_compiled(problem, option, max_steps: int):
    """Fixed-budget solve: solve(state, tau_1, tau_2) -> (state, steps)."""
    inner = solve_compiled_best(problem, option, max_steps)

    def solve(state, tau_1, tau_2):
        st, k, _ = inner(state, tau_1, tau_2, -float("inf"))
        return st, k

    return solve


_STATUS_KEYS = (
    "normNTdirx", "normNTdirw", "stepsize", "linesearch_status", "linesearch_counter",
    "linesearch_RightItem", "gradfNTdir", "singular_newton", "KrylovIterMethod_Iter",
    "KrylovIterMethod_RelRes", "NTdir_error1", "NTdir_error2", "NTdir_norm", "NTdir_angle",
    "CovDerivKKT_minabseigval",
)


class RIPM:
    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        kind = "Krylov" if self.option["KrylovIterMethod"] else "RepMat"
        self.name = (
            f"RIPM_{kind}_gamma{self.option['gamma']}_beta"
            f"{self.option['linesearch_beta']}_theta{self.option['linesearch_theta']}"
        )

    def run(self, problem) -> Output:
        """Host loop on one lane with the reference's run protocol."""
        option = self.option
        maybe_wandb_init(option, self.name)
        step_fn = make_step(problem, option)
        state, tau_1, tau_2 = init_state(problem, option)

        def status_row(st, info):
            status = {"Phi": st.phi, "sigma": st.sigma, "rho": st.rho,
                      "maxabsLagmult": max_abs_multiplier(st.z, st.y)}
            for key in _STATUS_KEYS:
                if key in info:
                    status[key] = info[key]
                elif key.startswith(("NTdir", "CovDeriv")):
                    if option["checkNTequation"]:
                        status[key] = None
                elif key.startswith("Krylov"):
                    if option["KrylovIterMethod"]:
                        status[key] = None
                else:
                    status[key] = None
            return status

        state, log, stop_reason = host_run(
            option=option,
            state=state,
            step=lambda st: step_fn(st, tau_1, tau_2),
            evaluate=lambda xp, st: evaluation(problem, xp, st.x, st.z, st.y),
            status_row=status_row,
            get_x=lambda st: st.x,
            stop_flag=lambda st, info: (
                "Singular Newton system: the condensed saddle solve returned a "
                "non-finite direction; exiting with logs preserved"
                if bool(info.get("singular_newton", torch.zeros(1, dtype=torch.bool))[0])
                else None
            ),
            verbosity_line=lambda i, ev: (
                f"Iter: {i}, Cost: {ev['cost']}, KKT residual: {ev['residual']}"
            ),
        )
        self.option["stoppingcriterion"] = stop_reason
        maybe_wandb_finish(option)
        opt_out = {k: v for k, v in self.option.items() if not callable(v)}
        return Output(
            name=self.name,
            x=state.x[0],
            ineqLagmult=state.z[0],
            eqLagmult=state.y[0],
            option=copy.deepcopy(opt_out),
            log=log,
        )

"""RSQO: Riemannian Sequential Quadratic Optimization (Obara-Okuno-Takeda).

Counterpart of ``riptrm_tpu/solvers/rsqo.py``, over lanes: the state
carries ``x`` [B, ...], the inequality multipliers ``y`` [B, m], the
equality multipliers ``z`` [B, l], the penalty ``rho`` [B] and, for the
Newton-Schulz QP, the previous QP's inverse ``qp_xinv`` [B, dim, dim]
([B, 0, 0] otherwise).  A step materialises the Lagrangian Hessian in the
tangent basis (or takes the problem's closed forms of it and of the
linearised constraint rows, ``Problem.hessian_coords_at`` and
``ineq_rows_at``), regularises it (``quadoptim_type``: 'reghess'
eigenvalue clamp, 'reghess_operator' in the eigenbasis, 'reghess_shift'
certified diagonal shift, or 'eye'), solves the tangent-space QP
(``ops/qp.py``, a lane-masked IPM) and backtracks on the l1 penalty (a
lane-masked loop).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from riptrm_torch.ops.basis import constraint_grad_rows, materialize_symmetrized
from riptrm_torch.ops.kkt import compute_residual, evaluation
from riptrm_torch.ops.qp import METHODS, solve_qp
from riptrm_torch.ops.spectrum import eigh_nan, lanczos
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
from riptrm_torch.utils.lanes import bcast
from riptrm_torch.utils.lanes import dot as _dot
from riptrm_torch.utils.lanes import lane_loop
from riptrm_torch.utils.lanes import mv as _mv
from riptrm_torch.utils.spans import span

QUADOPTIM_TYPES = ("reghess", "reghess_operator", "reghess_shift", "eye")


def default_option():
    """The JAX package's defaults (``riptrm_tpu/solvers/rsqo.py``)."""
    return {
        "maxtime": 100,
        "maxiter": 100,
        "tolresid": 1e-6,
        "quadoptim_type": "reghess",
        "quadoptim_eigvalcorr": 1e-8,
        "quadoptim_eigvalthld": 1e-5,
        "quadoptim_maxiter": 400,
        "quadoptim_abstol": 1e-12,
        "quadoptim_reltol": 1e-12,
        "quadoptim_feastol": 1e-12,
        # warm-start each QP's dual from the SQP iterate's multipliers
        # (False: the reference's cold start)
        "quadoptim_warm_start": True,
        # 'chol', 'lu', 'schulz' or 'schulz_polish' (ops/qp.py::solve_qp)
        "quadoptim_linear_solver": "chol",
        "rho": 1.0,
        "tau": 0.5,
        "beta": 0.9,
        "gamma": 0.25,
        "linesearch_max": 10000,
        "linesearch_threshold": 1e-8,
        "verbosity": 0,
        "wandb_logging": False,
        "do_exit_on_error": True,
    }


@dataclasses.dataclass
class RsqoState:
    x: torch.Tensor
    y: torch.Tensor  # inequality multipliers [B, m]
    z: torch.Tensor  # equality multipliers [B, l]
    rho: torch.Tensor
    # the previous QP's first-iteration Newton-Schulz inverse (schulz
    # solvers: [B, dim, dim], all zero = cold; otherwise [B, 0, 0])
    qp_xinv: torch.Tensor


def _schulz(option):
    return option.get("quadoptim_linear_solver") in ("schulz", "schulz_polish")


def state_from_numpy(d, device=None, dtype=None, manifold=None) -> RsqoState:
    """Port's state from a dict of arrays (e.g. a JAX ``RsqoState``'s
    ``_asdict()``, whose ``qp_xinv`` is None outside the schulz solvers)."""
    d = dict(d)
    if d.get("qp_xinv") is None:
        d["qp_xinv"] = np.zeros(np.shape(d["rho"]) + (0, 0))
    return base.state_from_numpy(RsqoState, d, scalar_field="rho", device=device, dtype=dtype,
                                 manifold=manifold)


def state_to_numpy(state: RsqoState) -> dict:
    """Inverse of ``state_from_numpy`` (``qp_xinv`` None when empty)."""
    out = base.state_to_numpy(state)
    if out["qp_xinv"].size == 0:
        out["qp_xinv"] = None
    return out


def _shift_regularize(q, thld, corr):
    """Positive-definite regularisation by a certified diagonal shift
    (``reghess_shift``), per lane: the extreme eigenvalues from a 12-step
    dense Lanczos, the shift s = max(0, corr - lam_min + 0.01 |lam_min| +
    thld), escalated (x4 + step) until the Cholesky factor of Q + s I
    succeeds, at most 6 tries."""
    lanes, dim, dt, dev = q.shape[0], q.shape[-1], q.dtype, q.device
    eye = torch.eye(dim, dtype=dt, device=dev)
    v0 = torch.ones(dim, dtype=dt, device=dev) + torch.linspace(0.0, 1.0, dim, dtype=dt,
                                                                device=dev)
    v0 = (v0 / torch.linalg.vector_norm(v0)).expand(lanes, dim)
    _, _, ritz = lanczos(lambda v: _mv(q, v), v0, _dot, min(12, dim))
    lam_min, rho_max = ritz[:, 0], ritz[:, -1]
    s = torch.clamp(corr - lam_min + 0.01 * torch.abs(lam_min) + thld, min=0.0).to(dt)
    step = (thld + 0.01 * torch.abs(rho_max)).to(dt)
    ok = torch.zeros(lanes, dtype=torch.bool, device=dev)
    k = torch.zeros(lanes, dtype=torch.int64, device=dev)

    def running(s, ok, k):
        return ((~ok) & (k < 6)).any()

    def escalate(_, s, ok, k):
        active = (~ok) & (k < 6)
        _, info = torch.linalg.cholesky_ex(q + s[:, None, None] * eye)
        ok_try = info == 0
        s = torch.where(active, torch.where(ok_try, s, 4.0 * s + step), s)
        ok = torch.where(active, ok_try, ok)
        return s, ok, k + active.to(k.dtype)

    s, _, _ = lane_loop(running, escalate, (s, ok, k))
    return q + s[:, None, None] * eye


def _ell1_penalty(problem, x, rho):
    """f + rho (sum max(0, g) + sum |h|), per lane."""
    val = problem.cost(x)
    vio = torch.zeros_like(val)
    if problem.has_ineq:
        vio = vio + torch.sum(torch.clamp(problem.ineq_val(x), min=0.0), dim=-1)
    if problem.has_eq:
        vio = vio + torch.sum(torch.abs(problem.eq_val(x)), dim=-1)
    return val + rho * vio


def _regularize(q_raw, qtype, thld, corr, lanes, dim, dt, dev):
    """The QP's positive-definite Q from the materialised Lagrangian Hessian
    ``q_raw`` [B, dim, dim] by ``quadoptim_type``, and the coordinate
    rotation into its eigenbasis ('reghess_operator'; None otherwise)."""
    if qtype in ("reghess", "reghess_operator"):
        w, v = eigh_nan(q_raw)
        w = torch.where(w < thld, torch.full_like(w, corr), w)
        if qtype == "reghess_operator":
            # the operator's spectrum clamped, Q diagonal in its eigenbasis:
            # every coordinate rotated into it (coords_new = V' coords_old)
            return torch.diag_embed(w), v.mT
        q_mat = (v * w[:, None, :]) @ v.mT
        return 0.5 * (q_mat + q_mat.mT), None
    if qtype == "reghess_shift":
        return _shift_regularize(q_raw, thld, corr), None
    return torch.eye(dim, dtype=dt, device=dev).expand(lanes, dim, dim), None


def _ell1_line_search(problem, option, x, direction, rho, df0):
    """Backtracking on the l1 penalty, lane-masked: a lane that has found
    its step keeps it while the others backtrack.  Returns (stepsize, point
    there, backtracks), each per lane."""
    man = problem.manifold
    beta = option["beta"]
    ls_max = option["linesearch_max"]
    ls_threshold = option["linesearch_threshold"]
    f0 = _ell1_penalty(problem, x, rho)
    def trial(stepsize):
        x_new = man.retract(x, bcast(stepsize, direction) * direction)
        return x_new, _ell1_penalty(problem, x_new, rho)

    def need(stepsize, gdf0, f_new, k):
        # NaN-robust Armijo: a non-finite trial value keeps backtracking
        bound = f0 - gdf0
        accept = (f_new <= bound) | (torch.abs(f_new - bound) <= ls_threshold)
        return (~accept | ~torch.isfinite(f_new)) & (k < ls_max) & (stepsize > 1e-20)

    stepsize = torch.ones_like(rho)
    gdf0 = option["gamma"] * df0
    x_new, f_new = trial(stepsize)
    k = torch.zeros(rho.shape, dtype=torch.int64, device=rho.device)

    def running(stepsize, gdf0, x_new, f_new, k):
        return need(stepsize, gdf0, f_new, k).any()

    def backtrack(_, stepsize, gdf0, x_new, f_new, k):
        active = need(stepsize, gdf0, f_new, k)
        step_try = stepsize * beta
        x_try, f_try = trial(step_try)
        stepsize = torch.where(active, step_try, stepsize)
        gdf0 = torch.where(active, gdf0 * beta, gdf0)
        x_new = torch.where(bcast(active, x_new), x_try, x_new)
        f_new = torch.where(active, f_try, f_new)
        return stepsize, gdf0, x_new, f_new, k + active.to(k.dtype)

    stepsize, _, x_new, _, k = lane_loop(running, backtrack, (stepsize, gdf0, x_new, f_new, k))
    return stepsize, x_new, k


def _check_slice(option):
    if option["quadoptim_type"] not in QUADOPTIM_TYPES:
        raise ValueError(f"quadoptim_type {option['quadoptim_type']!r}: one of {QUADOPTIM_TYPES}")
    if option["quadoptim_linear_solver"] not in METHODS:
        raise ValueError(f"quadoptim_linear_solver {option['quadoptim_linear_solver']!r}: "
                         f"one of {METHODS}")


def make_step(problem, option):
    """Build ``step(state) -> (state, info)``; ``info`` is a dict of [B]
    tensors with the JAX step's keys."""
    _check_slice(option)
    man = problem.manifold
    dim = man.dim
    m = problem.num_ineq
    l = problem.num_eq
    qtype = option["quadoptim_type"]
    thld = option["quadoptim_eigvalthld"]
    corr = option["quadoptim_eigvalcorr"]
    tau = option["tau"]
    tolresid = option["tolresid"]
    qp_kw = dict(
        abstol=max(option["quadoptim_abstol"], tolresid),
        reltol=max(option["quadoptim_reltol"], tolresid),
        feastol=max(option["quadoptim_feastol"], tolresid),
        maxiter=option["quadoptim_maxiter"],
        method=option["quadoptim_linear_solver"],
    )

    def q_raw_at(x, y, z, basis):
        closed = problem.hessian_coords_at(x, y)
        if closed is not None:
            return closed()[0]
        return materialize_symmetrized(man, x, basis, problem.lag_rhess_at(x, y, z))

    def step(state: RsqoState):
        x, y, z, rho = state.x, state.y, state.z, state.rho
        lanes, dt, dev = rho.shape[0], y.dtype, rho.device
        basis = man.basis(x)

        # ---- regularised Lagrangian Hessian in coordinates ------------
        with span("riptrm.rsqo.regularize"):
            q_raw = None if qtype == "eye" else q_raw_at(x, y, z, basis)
            q_mat, coord_rot = _regularize(q_raw, qtype, thld, corr, lanes, dim, dt, dev)

        p_vec = man.to_coords(x, basis, problem.rgrad(x))

        # ---- linearised constraints -----------------------------------
        if m > 0:
            g_mat = problem.ineq_rows_at(x, basis)
            g_mat = (constraint_grad_rows(man, x, basis, problem.ineq_fn, m, dtype=dt)
                     if g_mat is None else g_mat.to(dt))
            h_vec = -problem.ineq_val(x)
        else:
            g_mat = torch.zeros((lanes, 0, dim), dtype=dt, device=dev)
            h_vec = torch.zeros((lanes, 0), dtype=dt, device=dev)
        if l > 0:
            a_mat = constraint_grad_rows(man, x, basis, problem.eq_fn, l, dtype=dt)
            b_vec = -problem.eq_val(x)
        else:
            a_mat = torch.zeros((lanes, 0, dim), dtype=dt, device=dev)
            b_vec = torch.zeros((lanes, 0), dtype=dt, device=dev)
        if coord_rot is not None:
            p_vec = _mv(coord_rot, p_vec)
            g_mat = g_mat @ coord_rot.mT
            a_mat = a_mat @ coord_rot.mT

        # ---- tangent-space QP, warm-started from the SQP multipliers --
        with span("riptrm.rsqo.qp"):
            sol = solve_qp(
                q_mat, p_vec, g_mat, h_vec, a_mat, b_vec,
                warm_z=y if (m > 0 and option["quadoptim_warm_start"]) else None,
                xinv0=state.qp_xinv if state.qp_xinv.numel() else None,
                **qp_kw,
            )
        coeff, y_new, z_new = sol.x, sol.z, sol.y
        df0 = _dot(coeff, _mv(q_mat, coeff))
        coeff_basis = coeff if coord_rot is None else _mv(coord_rot.mT, coeff)
        direction = man.from_coords(x, basis, coeff_basis)
        normdx = man.norm(x, direction)

        # ---- penalty update -------------------------------------------
        upsilon = torch.zeros_like(rho)
        if m > 0:
            upsilon = torch.maximum(upsilon, torch.amax(y_new, dim=-1))
        if l > 0:
            upsilon = torch.maximum(upsilon, torch.amax(torch.abs(z_new), dim=-1))
        rho = torch.where(rho < upsilon, upsilon + tau, rho)

        # ---- l1 penalty line search -----------------------------------
        with span("riptrm.rsqo.line_search"):
            stepsize, x_new, k = _ell1_line_search(problem, option, x, direction, rho, df0)

        new_state = RsqoState(
            x=x_new, y=y_new, z=z_new, rho=rho,
            qp_xinv=sol.xinv if sol.xinv is not None else state.qp_xinv,
        )
        info = {
            "rho": rho,
            "upsilon": upsilon,
            "quadoptim_status": sol.status,
            "quadoptim_iter": sol.iterations,
            "quadoptim_gap": sol.gap,
            "quadoptim_primalinfeasibility": sol.primal_infeasibility,
            "quadoptim_dualinfeasibility": sol.dual_infeasibility,
            "normdx": normdx,
            "stepsize": stepsize,
            "df0": df0,
            "linesearch_status": k < option["linesearch_max"],
            "linesearch_counter": k,
        }
        return new_state, info

    return step


def init_state(problem, option):
    """One-lane initial state; every field in the coordinate dtype (that of
    x0), which the QP's outputs follow.  A lossy cast of the duals is
    refused."""
    x0 = problem.x0[None]
    dtype, dev = x0.dtype, x0.device
    for name in ("y0", "z0"):
        arr = getattr(problem, name)
        if arr.numel() and torch.promote_types(arr.dtype, dtype) != dtype:
            raise ValueError(
                f"RSQO: problem.{name} has dtype {arr.dtype} but the coordinate dtype is "
                f"{dtype}; casting would silently truncate the duals — cast x0 or the "
                "duals explicitly"
            )
    dim = problem.manifold.dim if _schulz(option) else 0
    return RsqoState(
        x=x0,
        y=problem.y0[None].to(dtype),
        z=problem.z0[None].to(dtype),
        rho=torch.full((1,), option["rho"], dtype=dtype, device=dev),
        qp_xinv=torch.zeros((1, dim, dim), dtype=dtype, device=dev),
    )


def solve_compiled_best(problem, option, max_steps: int):
    """Fixed-budget solve over the lanes of a state, tracking the best KKT
    residual (seeded with the initial residual); a lane stops once its
    best <= target or at the residual tolerance, the budget being
    min(max_steps, maxiter).  Returns solve(state, target) -> (state,
    steps [B], best [B])."""
    option = merge_options(default_option(), option or {})
    step = make_step(problem, option)
    tolresid = option["tolresid"]

    def residual(st):
        return compute_residual(problem, st.x, st.y, st.z)[0]

    def step1(st):
        new_st, _ = step(st)
        res = residual(new_st)
        stop = res <= tolresid
        return new_st, res, torch.ones_like(stop), stop

    def solve(state, target):
        st, k, _, best = compiled_best_while(
            step1, state, target, min(max_steps, option["maxiter"]), residual(state),
            stall_window=option.get("sweep_stall_window"),
        )
        return st, k, best

    return solve


def solve_compiled(problem, option, max_steps: int):
    """Fixed-budget solve: solve(state) -> (state, steps)."""
    inner = solve_compiled_best(problem, option, max_steps)

    def solve(state):
        st, k, _ = inner(state, -float("inf"))
        return st, k

    return solve


_STATUS_KEYS = (
    "upsilon", "quadoptim_status", "quadoptim_iter", "quadoptim_gap",
    "quadoptim_primalinfeasibility", "quadoptim_dualinfeasibility", "normdx", "stepsize",
    "df0", "linesearch_status", "linesearch_counter",
)


class RSQO:
    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        self.name = (
            f"RSQO_{self.option['quadoptim_type']}_corr"
            f"{self.option['quadoptim_eigvalcorr']:.0e}"
        )

    def run(self, problem) -> Output:
        """Host loop on one lane with the reference's run protocol."""
        option = self.option
        maybe_wandb_init(option, self.name)
        state = init_state(problem, option)
        step = make_step(problem, option)

        def status_row(st, info):
            return {"rho": st.rho, "maxabsLagmult": max_abs_multiplier(st.y, st.z)} | {
                key: info.get(key) for key in _STATUS_KEYS}

        state, log, stop_reason = host_run(
            option=option,
            state=state,
            step=step,
            evaluate=lambda xp, st: evaluation(problem, xp, st.x, st.y, st.z),
            status_row=status_row,
            get_x=lambda st: st.x,
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
            ineqLagmult=state.y[0],
            eqLagmult=state.z[0],
            option=copy.deepcopy(opt_out),
            log=log,
        )

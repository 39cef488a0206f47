"""RIPTRM: Riemannian primal-dual Interior Point Trust-Region Method.

Counterpart of ``riptrm_tpu/solvers/riptrm.py``.  As there, the inner x
outer loop nest is one ``step``: an inner trust-region iteration whose
"converged" branch also applies the outer barrier-parameter update.  The
step acts on every lane of a ``RiptrmState`` at once (``x`` [B, n] on the
sphere or [B, n, p] on Stiefel, ``y`` [B, m], per-lane scalars [B]); each
lane follows exactly the JAX step's branches
(``torch.where`` in place of ``jnp.where``).  The same step powers the host
runner (``RIPTRM.run``, B = 1) and the fixed-budget loop
(``solve_compiled``, any B; ``parallel/sweep.py``).

Both direction solvers of the JAX package run: ``TRS_solver='tCG'`` and
``'Exact_RepMat'``, which materialises Hw in the tangent basis
(``ops/basis.py``, or the problem's closed form, ``hessian_coords_at``) and
solves the TRS exactly (``ops/trs.py``: ``eigh``, or
Moré-Sorensen by Cholesky at dim >= 256 under ``exact_trs_method='auto'``),
with the per-lane cache of the materialised Hw.  The second-order criterion
reads the least eigenvalue of Hw at the trial point: from the exact mode's
materialisation there, or in tCG mode from a Lanczos Ritz minimum.  Where
JAX branches with ``lax.cond`` (the cache, the Lanczos gate), the port
computes the branch for every lane when any lane takes it and selects per
lane: a lane's values depend on that lane alone.

``compensated_reductions`` computes the complementarity norm and ared's
barrier log-ratio sum with the compensated reductions of
``ops/compensated.py``, as the JAX step does.  ``RIPTRM.run`` checkpoints
its state, elapsed budget and log to ``checkpoint_path`` every
``checkpoint_every`` seconds of row time and, with ``resume``, continues
from that file (``experiment/checkpoint.py``); ``wandb_logging`` logs its
rows through ``solvers/base.py``'s wandb hooks.

``use_fused_tcg`` (the JAX ``use_pallas_tcg``, which the port refuses by
that name) runs the tCG as the hand-written kernel the problem gives
(``Problem.fused_tcg_at``, ``problems/structured.py``), and the plain
``truncated_cg`` where it gives none.  Exact mode runs no tCG.

``solve_compiled(..., return_done=True)`` also returns each lane's stop
flag; ``solve_compiled_traced`` records a per-lane, per-step trace.

``sweep_stall_window`` and ``keep_best_point`` (the JAX options of the
same names) reach ``base.compiled_best_while`` from the fixed-budget
loop.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time

import torch

from riptrm_torch.ops import kernels
from riptrm_torch.ops.basis import materialize_symmetrized
from riptrm_torch.ops.compensated import barrier_log_ratio_sum, complementarity_norm
from riptrm_torch.ops.kkt import compute_residual, evaluation
from riptrm_torch.ops.spectrum import eigh_nan, eigvalsh_nan, lanczos
from riptrm_torch.ops.tcg import truncated_cg
from riptrm_torch.ops.trs import solve_trs_eig, solve_trs_ms
from riptrm_torch.solvers import base
from riptrm_torch.solvers.base import (
    LogAccumulator,
    Output,
    WallClock,
    compiled_best_while,
    lane0_to_host,
    maybe_wandb_finish,
    maybe_wandb_init,
    maybe_wandb_log,
    merge_options,
)
from riptrm_torch.utils.lanes import dot as _dot
from riptrm_torch.utils.lanes import tracing
from riptrm_torch.utils.lanes import where_lanes as _lanes
from riptrm_torch.utils.spans import span

# inner_status codes
INNER_INITIAL = 0
INNER_CONVERGED = 1
INNER_SUCCESSFUL = 2
INNER_UNSUCCESSFUL = 3
INNER_PRIMAL_INFEASIBLE = 4
INNER_MAX_TIME = 5
INNER_MAX_ITER = 6

INNER_STATUS_NAMES = {
    INNER_INITIAL: "initial",
    INNER_CONVERGED: "converged",
    INNER_SUCCESSFUL: "successful",
    INNER_UNSUCCESSFUL: "unsuccessful",
    INNER_PRIMAL_INFEASIBLE: "primal_infeasible",
    INNER_MAX_TIME: "max-time-exceeded",
    INNER_MAX_ITER: "max-iter-exceeded",
}

RADIUS_NAMES = {-1: None, 0: "unchanged", 1: "reduced", 2: "expanded"}
TCG_NAMES = {
    0: "tCG_MAX_INNER_ITER",
    1: "tCG_NEGATIVE_CURVATURE",
    2: "tCG_EXCEEDED_TR",
    3: "tCG_MODEL_INCREASED",
    4: "tCG_REACHED_TARGET_LINEAR",
    5: "tCG_REACHED_TARGET_SUPERLINEAR",
}
TRS_NAMES = {0: "interior", 1: "boundary", 2: "hardcase"}


def default_option():
    """The JAX package's defaults (``riptrm_tpu/solvers/riptrm.py``)."""
    return {
        "maxtime": 240,
        "maxiter": 100,
        "tolresid": 1e-15,
        "inner_maxiter": None,
        "inner_maxtime": None,
        "initial_TR_radius": None,
        "minimal_initial_TR_radius": 1e-15,
        "maximal_TR_radius": 10.0,
        "rho": 0.1,
        "reduction_regularization": 1e3,
        "gamma": 0.25,
        "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-14),
        "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=1e-14),
        "forcing_function_second_order": lambda mu: mu,
        "min_barrier_parameter": 1e-15,
        "TRS_solver": "Exact_RepMat",  # or 'tCG'
        # exact-mode TRS: 'eigh', 'ms' (Moré-Sorensen by Cholesky) or 'auto'
        # (ms at dim >= 256, eigh below)
        "exact_trs_method": "auto",
        "second_order_stationarity": True,
        "second_order_lanczos_iters": 64,
        "tCG_theta": 1.0,
        "tCG_kappa": 0.1,
        "tCG_mininner": 1,
        "initial_barrier_parameter": 0.1,
        "barrier_parameter_update_r": 0.01,
        "barrier_parameter_update_c": 0.5,
        "barrier_parameter_update_b": 0.8,
        "do_simple_barrier_parameter_update": True,
        "const_left": 0.5,
        "const_right": 1e20,
        "checkTRSoptimality": False,
        # Run the whole tCG as one hand-written kernel where the problem
        # gives one (Problem.fused_tcg_at; float32 inside).
        "use_fused_tcg": False,
        "compensated_reductions": False,
        "verbosity": 0,
        "save_inner_iteration": True,
        "wandb_logging": False,
        "do_exit_on_error": True,
        "checkpoint_path": None,
        "checkpoint_every": 30.0,
        "resume": False,
        # Accepted for reference-config compatibility; no-ops here.
        "do_euclidean_lincomb": False,
        "is_euclidean_embedded": False,
        "basisfun": None,
        "TRS_tolresid": 1e-12,
        "TRS_tolhardcase": 1e-8,
    }


_NOT_PORTED = (
    ("use_pallas_tcg", bool,
     "use_pallas_tcg={!r} is the JAX package's name: the port's option is "
     "use_fused_tcg"),
)


def check_slice(option):
    """Raise NotImplementedError for an option outside the ported slice."""
    for key, unsupported, msg in _NOT_PORTED:
        if unsupported(option.get(key)):
            raise NotImplementedError(msg.format(option.get(key)))


@dataclasses.dataclass
class RiptrmState:
    """Solver state over lanes: points [B, ...], multipliers [B, m],
    scalars [B]."""

    x: torch.Tensor
    y: torch.Tensor
    mu: torch.Tensor
    tr_radius: torch.Tensor
    outer_iter: torch.Tensor  # completed outer iterations (int64)
    inner_count: torch.Tensor  # inner iterations in the current outer step
    # Inner-loop initial values, for budget-exceeded resets
    inner_x0: torch.Tensor
    inner_y0: torch.Tensor
    inner_tr0: torch.Tensor
    # Exact-mode cache of the materialised Hw and cx at the current point
    # (zero-sized in tCG mode).  eigh mode: Hw = h_q diag(h_lam) h_q' with
    # h_lam ascending; ms mode: h_q is the raw matrix and h_lam holds only
    # the Lanczos extremes at [0] and [-1].
    cache_valid: torch.Tensor  # [B] bool
    h_lam: torch.Tensor  # [B, dim]
    h_q: torch.Tensor  # [B, dim, dim]
    c_vec: torch.Tensor  # [B, dim]

    @property
    def lanes(self) -> int:
        return self.x.shape[0]


def state_from_numpy(d, device=None, dtype=None, manifold=None) -> RiptrmState:
    """Port's state from a dict of arrays, e.g. ``jax.device_get(state)
    ._asdict()`` of a JAX ``RiptrmState``: an unbatched state becomes one
    lane, a vmapped one keeps its lanes, whatever the point's rank (a vector
    [n] on the sphere, a frame [n, p] on Stiefel); a tuple point (Product,
    fixed rank) is packed by ``manifold.pack``.  Float fields take
    ``dtype`` (default: the dtype of ``x``); every field lands on
    ``device`` (default: the card, ``config.resolve``)."""
    return base.state_from_numpy(RiptrmState, d, scalar_field="mu",
                                 int_fields=("outer_iter", "inner_count"),
                                 device=device, dtype=dtype, manifold=manifold)


state_to_numpy = base.state_to_numpy


def _barrier_ops(problem, x, y, mu):
    """Condensed barrier-KKT operator pieces at (x, y, mu): the slack c, the
    operator Hw(dx) = Hess_x L[dx] + Gx(y * Gxaj(dx) / c) with the point's
    work done once, and cx = grad f - Gx(mu / c).  Hw is the family's one
    operator where it gives one (``Problem.barrier_hvp_at``), else composed
    from the Lagrangian's Hessian image and the constraint operators."""
    c = problem.slack(x)
    gx = problem.gx_at(x)
    hw = problem.barrier_hvp_at(x, y, c)
    if hw is None:
        lag_hvp = problem.lag_rhess_at(x, y)
        gx_adj = problem.gx_adj_at(x)

        def hw(dx):
            return lag_hvp(dx) + gx((y * gx_adj(dx)) / c)

    cx_vec = problem.rgrad(x) - gx(mu[:, None] / c)
    return c, hw, cx_vec


def _log_barrier(problem, x, mu):
    """phi(x) = f(x) - mu sum log c(x), finite at infeasible points."""
    c = problem.slack(x)
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    return problem.cost(x) - mu * torch.sum(torch.log(safe_c), dim=-1)


def _outer_update(option, mu):
    """Barrier parameter schedule."""
    simple = option["barrier_parameter_update_c"] * mu ** (
        1.0 + option["barrier_parameter_update_r"]
    )
    if not option["do_simple_barrier_parameter_update"]:
        simple = torch.minimum(option["barrier_parameter_update_b"] * mu, simple)
    return torch.clamp(simple, min=option["min_barrier_parameter"])


def exact_trs_method(option, dim):
    """The exact-mode TRS algorithm: ``exact_trs_method``, where 'auto'
    means 'ms' at dim >= 256 (where the dense eigh leads the step) and
    'eigh' below."""
    method = option["exact_trs_method"]
    if method == "auto":
        return "ms" if dim >= 256 else "eigh"
    return method


def _dense_ritz(h_mat):
    """Extreme Ritz values [B] of dense matrices [B, dim, dim]: 32 Lanczos
    steps from a fixed start."""
    dim, dt, dev = h_mat.shape[-1], h_mat.dtype, h_mat.device
    v0 = torch.ones(dim, dtype=dt, device=dev) + torch.linspace(0.0, 1.0, dim, dtype=dt,
                                                                device=dev)
    v0 = (v0 / torch.linalg.vector_norm(v0)).expand(h_mat.shape[0], dim)
    _, _, ritz = lanczos(lambda v: torch.einsum("bij,bj->bi", h_mat, v), v0, _dot,
                         min(32, dim))
    return ritz[:, 0], ritz[:, -1]


def materialize_at(problem, x, y, mu, ms):
    """The exact-mode cache payload at (x, y, mu): (h_lam, h_q, c_vec), Hw
    and cx in the tangent basis.  ``ms`` False: Hw eigendecomposed (h_lam
    ascending); True: h_q is the raw matrix and h_lam holds its Lanczos
    extremes at [:, 0] and [:, -1]."""
    closed = problem.hessian_coords_at(x, y)
    if closed is not None:
        c = problem.slack(x)
        h_mat, c_vec = closed(y / c, mu[:, None] / c)
    else:
        man = problem.manifold
        basis = man.basis(x)
        _, hw, cx = _barrier_ops(problem, x, y, mu)
        h_mat = materialize_symmetrized(man, x, basis, hw)
        c_vec = man.to_coords(x, basis, cx)
    if ms:
        lam_lo, lam_hi = _dense_ritz(h_mat)
        h_lam = h_mat.new_zeros(h_mat.shape[:2])
        h_lam[:, -1] = lam_hi
        h_lam[:, 0] = lam_lo
        return h_lam, h_mat, c_vec
    h_lam, h_q = eigh_nan(h_mat)
    return h_lam, h_q, c_vec


def make_step(problem, option, callbacks=True):
    """Build the inner-step function ``step(state) -> (state, info)``;
    ``info`` is a dict of [B] tensors with the JAX step's keys, and the
    problem's callback metrics unless ``callbacks`` is False.  The
    fixed-budget loop reads only the residual and the converged flag, and
    builds its step without them, as XLA drops the JAX step's unread
    callback from the compiled loop."""
    check_slice(option)
    man = problem.manifold
    dim = man.dim
    exact = option["TRS_solver"] == "Exact_RepMat"
    trs_ms = exact and exact_trs_method(option, dim) == "ms"
    second_order = option["second_order_stationarity"]
    ff_lag = option["forcing_function_Lagrangian"]
    ff_compl = option["forcing_function_complementarity"]
    ff_second = option["forcing_function_second_order"]
    inner_maxiter = option["inner_maxiter"]
    compensated = option["compensated_reductions"]
    tcg_kw = dict(
        theta=option["tCG_theta"],
        kappa=option["tCG_kappa"],
        mininner=option["tCG_mininner"],
        maxinner=dim,
    )

    def step(state: RiptrmState):
        x, y, mu, tr_radius = state.x, state.y, state.mu, state.tr_radius
        dt = y.dtype
        with span("riptrm.riptrm.barrier"):
            c, hw, cx = _barrier_ops(problem, x, y, mu)

        # ---- direction -------------------------------------------------
        h_lam, h_q, c_vec = state.h_lam, state.h_q, state.c_vec
        if exact:
            stale = ~state.cache_valid
            with span("riptrm.riptrm.materialize"):
                # per-lane select: under tracing every lane computes it
                if tracing() or bool(stale.any()):
                    fresh = materialize_at(problem, x, y, mu, trs_ms)
                    h_lam, h_q, c_vec = (_lanes(stale, f, old) for f, old in
                                         zip(fresh, (h_lam, h_q, c_vec)))
            with span("riptrm.riptrm.trs"):
                if trs_ms:
                    coeff, lam1, trs_code, _ = solve_trs_ms(
                        h_q, c_vec, tr_radius, lam_est=(h_lam[:, 0], h_lam[:, -1])
                    )
                    h_coeff = torch.einsum("bij,bj->bi", h_q, coeff)  # h_q: the raw Hw
                    hw_dx_dx = _dot(coeff, h_coeff)
                else:
                    coeff, lam1, trs_code, p_c = solve_trs_eig(h_lam, h_q, c_vec, tr_radius)
                    hw_dx_dx = _dot(p_c, h_lam * p_c)
                dx = man.from_coords(x, man.basis(x), coeff)
                cx_dx = _dot(c_vec, coeff)
            dxtype = trs_code.to(torch.int64)
            tcg_iters = torch.zeros_like(dxtype)
        else:
            with span("riptrm.riptrm.direction"):
                tcg = problem.fused_tcg_at(x, y, c) if option["use_fused_tcg"] else None
                if tcg is None:
                    with span("riptrm.tcg"):
                        dx, h_dx, tcg_iters, tcg_code = truncated_cg(man, x, hw, cx, tr_radius,
                                                                     **tcg_kw)
                else:
                    dx, h_dx, tcg_iters, tcg_code = tcg(cx, tr_radius, **tcg_kw)
                hw_dx_dx = man.inner(x, dx, h_dx)
                cx_dx = man.inner(x, cx, dx)
            dxtype = 10 + tcg_code.to(torch.int64)
        normdx = man.norm(x, dx)

        # ---- optional TRS optimality self-check ------------------------
        trs_check = {}
        if option["checkTRSoptimality"]:
            if exact:
                mineig_hw, maxeig_hw = h_lam[:, 0], h_lam[:, -1]
            else:
                w_ev = eigvalsh_nan(materialize_symmetrized(man, x, man.basis(x), hw))
                mineig_hw, maxeig_hw = w_ev[:, 0], w_ev[:, -1]
            pred_chk = -0.5 * hw_dx_dx - cx_dx
            cx_norm = man.norm(x, cx)
            trs_check = {
                "TRS_cauchy_diff": pred_chk - 0.5 * cx_norm * torch.minimum(
                    tr_radius, cx_norm / maxeig_hw),
                "TRS_eigen_diff": pred_chk + 0.5 * tr_radius**2 * mineig_hw,
                "TRS_mineig": mineig_hw,
            }
            if exact:
                if trs_ms:
                    kkt_vec = h_coeff + lam1[:, None] * coeff + c_vec
                else:
                    kkt_vec = (torch.einsum("bij,bj->bi", h_q, h_lam * p_c)
                               + lam1[:, None] * coeff + c_vec)
                trs_check["TRS_KKTresid"] = torch.linalg.vector_norm(kkt_vec, dim=-1)
                trs_check["TRS_compl"] = lam1 * (tr_radius - normdx)

        with span("riptrm.riptrm.trial"):
            # ---- trial point -----------------------------------------------
            dy = -y + mu[:, None] / c - y * problem.gx_adj(x, dx) / c
            with span("riptrm.riptrm.retract"):
                x_new = man.retract(x, dx)
            y_new = y + dy
            c_new = problem.slack(x_new)

            # ---- inner stopping criteria -----------------------------------
            xfeas = torch.all(c_new > 0, dim=-1)
            yfeas = torch.all(y_new > 0, dim=-1)
            norm_grad_lag = man.norm(x_new, problem.lag_rgrad(x_new, y_new))
            if compensated:
                compl = complementarity_norm(y_new, c_new, mu)
            else:
                compl = torch.linalg.vector_norm(y_new * c_new - mu[:, None], dim=-1)
            crit_lag = norm_grad_lag <= ff_lag(mu)
            crit_compl = compl <= ff_compl(mu)

            h_lam_new, h_q_new, c_vec_new = h_lam, h_q, c_vec
            if exact and second_order:
                with span("riptrm.riptrm.materialize"):
                    h_lam_new, h_q_new, c_vec_new = materialize_at(problem, x_new, y_new, mu,
                                                                   trs_ms)
                mineig = h_lam_new[:, 0]
                crit_eig = mineig >= -ff_second(mu)
            elif second_order:
                # Matrix-free criterion: the Lanczos Ritz minimum of Hw at the
                # trial point, on the lanes whose first-order tests hold (inf
                # elsewhere); Ritz minima approach lambda_min from above.
                first_ok = xfeas & yfeas & crit_lag & crit_compl
                mineig = torch.full_like(normdx, math.inf)
                if tracing() or bool(first_ok.any()):
                    _, hw_new, cx_new = _barrier_ops(problem, x_new, y_new, mu)
                    # deterministic start: barrier gradient plus the transported step
                    v0 = cx_new + 0.5 * man.transport(x, x_new, dx)
                    _, _, ritz = lanczos(
                        hw_new, v0, man.inner_at(x_new),
                        min(option["second_order_lanczos_iters"], dim),
                    )
                    mineig = torch.where(first_ok, ritz[:, 0].to(dt), mineig)
                crit_eig = mineig >= -ff_second(mu)
            else:
                mineig = torch.full_like(normdx, math.nan)
                crit_eig = torch.ones_like(xfeas)

            converged = xfeas & yfeas & crit_lag & crit_compl & crit_eig
            infeasible = (~converged) & (~xfeas)

            # ---- ared / pred and radius update -----------------------------
            # ared = [f(x) - f(xNew)] + mu * sum(log(cNew_i / c_i)): the
            # reference's phi(x) - phi(xNew) without the catastrophic
            # cancellation of two O(n) barrier sums.
            if compensated:
                barrier = barrier_log_ratio_sum(c_new, c, mu)
            else:
                safe_c = torch.where(c > 0, c, torch.ones_like(c))
                ratio = torch.where((c_new > 0) & (c > 0), c_new / safe_c, torch.ones_like(c))
                barrier = mu * torch.sum(torch.log(ratio), dim=-1)
            ared_raw = (problem.cost(x) - problem.cost(x_new)) + barrier
            phi_cur = _log_barrier(problem, x, mu)  # scale only (regularization)
            eps_dt = torch.finfo(dt).eps
            red_reg = (
                torch.clamp(torch.abs(phi_cur), min=1.0)
                * eps_dt
                * option["reduction_regularization"]
            )
            ared = ared_raw + red_reg
            pred = -0.5 * hw_dx_dx - cx_dx + red_reg

            shrink = ared < 0.25 * pred
            # |dx| == TR to 1e-15 at float64 (the reference); scaled with the
            # dtype's eps below that, or the radius never expands in float32.
            boundary_tol = 1e-15 if eps_dt < 1e-12 else 8.0 * eps_dt * tr_radius
            expand = (ared >= 0.75 * pred) & (torch.abs(normdx - tr_radius) <= boundary_tol)
            tr_updated = torch.where(
                shrink,
                0.25 * tr_radius,
                torch.where(
                    expand,
                    torch.clamp(2.0 * tr_radius, max=option["maximal_TR_radius"]),
                    tr_radius,
                ),
            )
            radius_update_code = torch.where(shrink, 1, torch.where(expand, 2, 0))
            accepted = ared > option["rho"] * pred

        # Dual clipping; I_right is a scalar max broadcast to every entry
        # (the reference's np.maximum(a, b, out) semantics).
        safe_c_new = torch.where(c_new > 0, c_new, torch.ones_like(c_new))
        i_left = option["const_left"] * torch.clamp(
            torch.minimum(y, mu[:, None] / safe_c_new), max=1.0
        )
        i_right = torch.clamp(option["const_right"] / mu, min=option["const_right"])
        y_clipped = torch.minimum(torch.maximum(y_new, i_left), i_right[:, None])
        dual_clipping = ~torch.all(y_new == y_clipped, dim=-1)

        # ---- combine branches ------------------------------------------
        status = torch.where(
            converged,
            INNER_CONVERGED,
            torch.where(
                infeasible,
                INNER_PRIMAL_INFEASIBLE,
                torch.where(accepted, INNER_SUCCESSFUL, INNER_UNSUCCESSFUL),
            ),
        )
        take_new_x = converged | ((~infeasible) & accepted)
        x_next = _lanes(take_new_x, x_new, x)
        y_next = _lanes(
            converged, y_new, _lanes((~infeasible) & accepted, y_clipped, y)
        )
        tr_next = torch.where(
            converged,
            tr_radius,
            torch.where(infeasible, option["gamma"] * normdx, tr_updated),
        )

        # Exact-mode cache: kept on rejected steps, replaced by the trial
        # point's materialisation on accepts without dual clipping (second
        # order), invalidated otherwise and at every outer transition.
        if exact:
            reuse_new = (~infeasible) & accepted & (~dual_clipping) & second_order
            cache_valid = infeasible | ((~converged) & (~accepted)) | reuse_new
            h_lam = _lanes(reuse_new, h_lam_new, h_lam)
            h_q = _lanes(reuse_new, h_q_new, h_q)
            c_vec = _lanes(reuse_new, c_vec_new, c_vec)
        else:
            cache_valid = torch.zeros_like(state.cache_valid)

        inner_count = state.inner_count + 1
        # inner_maxiter budget: reset to the inner loop's initial values and
        # force an outer transition.
        if inner_maxiter is not None:
            forced = (~converged) & (inner_count >= inner_maxiter)
        else:
            forced = torch.zeros_like(converged)
        exit_inner = converged | forced

        x_next = _lanes(forced, state.inner_x0, x_next)
        y_next = _lanes(forced, state.inner_y0, y_next)
        tr_next = torch.where(forced, state.inner_tr0, tr_next)
        status = torch.where(forced, INNER_MAX_ITER, status)

        # ---- outer transition on inner exit ----------------------------
        mu_next = torch.where(exit_inner, _outer_update(option, mu), mu)
        tr_next = torch.where(
            exit_inner,
            torch.clamp(tr_next, min=option["minimal_initial_TR_radius"]),
            tr_next,
        )
        outer_iter = state.outer_iter + exit_inner.to(state.outer_iter.dtype)
        inner_count = torch.where(exit_inner, 0, inner_count)

        new_state = RiptrmState(
            x=x_next,
            y=y_next,
            mu=mu_next,
            tr_radius=tr_next,
            outer_iter=outer_iter,
            inner_count=inner_count,
            inner_x0=_lanes(exit_inner, x_next, state.inner_x0),
            inner_y0=_lanes(exit_inner, y_next, state.inner_y0),
            inner_tr0=torch.where(exit_inner, tr_next, state.inner_tr0),
            cache_valid=cache_valid & ~exit_inner,
            h_lam=h_lam,
            h_q=h_q,
            c_vec=c_vec,
        )

        with span("riptrm.riptrm.evaluation"):
            info = evaluation(problem, x, x_next, y_next, callback=callbacks)
        skipped = converged | infeasible | forced
        has_ineq = problem.has_ineq
        inf = torch.full_like(normdx, math.inf)
        info.update(
            mu=mu,  # mu of the step that was just taken
            inner_status=status,
            num_inner=state.inner_count + 1,
            TR_radius=tr_radius,  # radius used this step (pre-update)
            dxtype=dxtype,
            normdx=normdx,
            minxfeasi=torch.amin(c_new, dim=-1) if has_ineq else inf,
            minyfeasi=torch.amin(y_new, dim=-1) if has_ineq else inf,
            compl=compl,
            mineigvalHw=mineig,
            ared_pred=ared / pred,
            radius_update=torch.where(skipped, -1, radius_update_code),
            dual_clipping=torch.where(
                skipped, -1, torch.where(accepted, dual_clipping.to(torch.int64), -1)
            ),
            maxabsLagmult=(
                torch.amax(torch.abs(y_next), dim=-1) if has_ineq
                else torch.zeros_like(normdx)
            ),
            converged=converged,
            exit_inner=exit_inner,
            outer_iter=outer_iter,
            tcg_iters=tcg_iters.to(torch.int32),
        )
        info.update(trs_check)
        return new_state, info

    return step


def make_force_outer(option):
    """Host-triggered inner-budget reset (``inner_maxtime``): revert to the
    inner loop's initial values and apply the outer barrier update."""

    def force_outer(state: RiptrmState):
        tr = torch.clamp(state.inner_tr0, min=option["minimal_initial_TR_radius"])
        return dataclasses.replace(
            state,
            x=state.inner_x0,
            y=state.inner_y0,
            tr_radius=tr,
            mu=_outer_update(option, state.mu),
            outer_iter=state.outer_iter + 1,
            inner_count=torch.zeros_like(state.inner_count),
            inner_tr0=tr,
            cache_valid=torch.zeros_like(state.cache_valid),
        )

    return force_outer


def init_state(problem, option):
    """One-lane initial state at (problem.x0, problem.y0).  The exact-mode
    cache is sized [1, dim] / [1, dim, dim] in exact mode and zero-sized in
    tCG mode, where nothing reads it."""
    check_slice(option)
    dim = problem.manifold.dim if option["TRS_solver"] == "Exact_RepMat" else 0
    x0 = problem.x0[None]
    y0 = torch.as_tensor(problem.y0)[None]
    dt, dev = y0.dtype, y0.device
    if option["initial_TR_radius"] is None:
        tr0 = problem.manifold.typical_dist / 8.0
    else:
        tr0 = option["initial_TR_radius"]
    tr0 = torch.full((1,), tr0, dtype=dt, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    return RiptrmState(
        x=x0,
        y=y0,
        mu=torch.full((1,), option["initial_barrier_parameter"], dtype=dt, device=dev),
        tr_radius=tr0,
        outer_iter=zero,
        inner_count=zero,
        inner_x0=x0,
        inner_y0=y0,
        inner_tr0=tr0,
        cache_valid=torch.zeros(1, dtype=torch.bool, device=dev),
        h_lam=torch.zeros((1, dim), dtype=dt, device=dev),
        h_q=torch.zeros((1, dim, dim), dtype=dt, device=dev),
        c_vec=torch.zeros((1, dim), dtype=dt, device=dev),
    )


class RIPTRM:
    """Host-facing solver with the reference's run protocol."""

    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        self.name = f"RIPTRM_{self.option['TRS_solver']}"

    # ------------------------------------------------------------------
    def run(self, problem) -> Output:
        """Wall-clock-budgeted host loop: one step per iteration (one lane),
        per-iteration logging, the reference's stopping semantics (residual
        check at outer transitions, budget resets)."""
        option = self.option
        maybe_wandb_init(option, self.name)
        log = LogAccumulator()
        state = init_state(problem, option)
        step = make_step(problem, option)
        if option["use_fused_tcg"] and state.x.is_cuda:
            kernels._build.load()  # build before the clock starts
        force_outer = (
            make_force_outer(option) if option["inner_maxtime"] is not None else None
        )

        # Resume from a checkpoint: the state, the elapsed budget and the
        # log so far.
        ckpt_path = option["checkpoint_path"]
        initial_elapsed = 0.0
        resumed = False
        if ckpt_path and option["resume"] and os.path.exists(ckpt_path):
            from riptrm_torch.experiment.checkpoint import load_state

            state, meta = load_state(ckpt_path, state, manifold=problem.manifold)
            initial_elapsed = float(meta.get("elapsed", 0.0))
            for k, v in meta.get("log", {}).items():
                log.log[k] = list(v)
            resumed = True
        clock = WallClock(option["maxtime"], initial_elapsed)
        last_ckpt = clock.elapsed()
        inner_start = clock.elapsed()

        eval0 = lane0_to_host(evaluation(problem, state.x, state.x, state.y))
        # iteration-0 row (outer loop first evaluation)
        status0 = {
            "mu": float(state.mu[0]),
            "num_inner": None,
            "inner_status": None,
            "TR_radius": None,
            "dxtype": None,
            "normdx": None,
            "minxfeasi": None,
            "minyfeasi": None,
            "compl": None,
            "mineigvalHw": None,
            "ared/pred": None,
            "radius_update": None,
            "dual_clipping": None,
            "maxabsLagmult": (
                float(torch.amax(torch.abs(state.y))) if problem.has_ineq else 0.0
            ),
        }
        if not resumed:  # the iteration-0 row is in the restored log
            log.add(0, 0.0, eval0, status0)
            maybe_wandb_log(option, eval0 | {"time": 0.0})

        stop_reason = None
        if eval0["residual"] <= option["tolresid"]:
            stop_reason = (
                f"KKT residual tolerance reached; current residual={eval0['residual']} "
                f"and tolresid={option['tolresid']}"
            )

        while stop_reason is None:
            try:
                state, info = step(state)
                info = lane0_to_host(info)  # one device->host transfer per step
            except Exception as e:  # do_exit_on_error
                if option["do_exit_on_error"]:
                    print(f"Error: {e}")
                    break
                raise
            converged = info["converged"]
            residual = info["residual"]
            outer_iter = info["outer_iter"]
            # Rows are logged under the *current* outer iteration (1-based);
            # outer_iter counts completed outer iterations.
            row_iter = outer_iter if info["exit_inner"] else outer_iter + 1
            row_time = clock.elapsed()
            if option["save_inner_iteration"] or info["exit_inner"]:
                # Logging is host bookkeeping, excluded from the budget.
                t_log = time.time()
                row = self._format_info(info)
                log.add(row_iter, row_time, row)
                maybe_wandb_log(option, row | {"time": row_time})
                clock.excluded += time.time() - t_log

            if ckpt_path and row_time - last_ckpt >= option["checkpoint_every"]:
                from riptrm_torch.experiment.checkpoint import save_state

                save_state(ckpt_path, state, {"elapsed": row_time, "log": log.as_dict()})
                last_ckpt = row_time

            if option["verbosity"] >= 1 and converged:
                print(
                    f"Outer iteration: {outer_iter}, Cost: {info['cost']}, "
                    f"KKT residual: {residual}, mu: {info['mu']}"
                )
            elif option["verbosity"] > 1:
                print(
                    f"Iter: {row_iter}-{info['num_inner']}, "
                    f"Cost: {info['cost']:.3e}, KKT resid: {residual:.3e}, "
                    f"TR: {info['TR_radius']:.3e}, "
                    f"Stat: {INNER_STATUS_NAMES[info['inner_status']]}"
                )

            # Wall-clock budget: revert to the inner loop's initial point
            # and stop.
            if clock.exceeded():
                state = dataclasses.replace(
                    state, x=state.inner_x0, y=state.inner_y0,
                    tr_radius=state.inner_tr0,
                )
                stop_reason = (
                    f"Max time exceeded; runtime={clock.elapsed():.2f} and "
                    f"maxtime={option['maxtime']}"
                )
                break

            # inner_maxtime budget: reset the inner loop and force the outer
            # transition.
            if (
                option["inner_maxtime"] is not None
                and not info["exit_inner"]
                and clock.elapsed() - inner_start >= option["inner_maxtime"]
            ):
                state = force_outer(state)
                inner_start = clock.elapsed()
            elif info["exit_inner"]:
                inner_start = clock.elapsed()
            if converged and residual <= option["tolresid"]:
                stop_reason = (
                    "KKT residual tolerance reached; current residual="
                    f"{residual} and tolresid={option['tolresid']}"
                )
                break
            if outer_iter >= option["maxiter"]:
                stop_reason = (
                    f"Max iteration count reached; maxiter={option['maxiter']} "
                    f"after {clock.elapsed():.2f} seconds"
                )
                break

        self.option["stoppingcriterion"] = stop_reason
        maybe_wandb_finish(option)
        opt_out = {k: v for k, v in self.option.items() if not callable(v)}
        return Output(
            name=self.name,
            x=state.x[0],
            ineqLagmult=state.y[0],
            eqLagmult=state.x.new_zeros(0),
            option=copy.deepcopy(opt_out),
            log=log.as_dict(),
        )

    @staticmethod
    def _format_info(info) -> dict:
        """Map status codes to the reference's string log values."""
        out = {}
        for k, v in info.items():
            if k in ("converged", "exit_inner", "outer_iter", "tcg_iters"):
                # measurement metadata, not reference log columns
                continue
            out[k] = v
        out["inner_status"] = INNER_STATUS_NAMES[info["inner_status"]]
        dxt = info["dxtype"]
        out["dxtype"] = TCG_NAMES[dxt - 10] if dxt >= 10 else TRS_NAMES[dxt]
        out["radius_update"] = RADIUS_NAMES[info["radius_update"]]
        dc = info["dual_clipping"]
        out["dual_clipping"] = None if dc < 0 else bool(dc)
        out["ared/pred"] = out.pop("ared_pred")
        return out

    # ------------------------------------------------------------------
    def _solve_loop(self, problem, max_steps: int):
        """solve(state, target) -> (state, steps, done, best) on every lane
        of ``state``, through ``base.compiled_best_while``."""
        option = self.option
        step = make_step(problem, option, callbacks=False)
        tolresid = option["tolresid"]
        maxiter = option["maxiter"]

        def step1(st):
            new_st, info = step(st)
            # The protocol metric counts only inner-converged steps.
            stop = (info["converged"] & (info["residual"] <= tolresid)) | (
                new_st.outer_iter >= maxiter
            )
            return new_st, info["residual"], info["converged"], stop

        def solve(state, target):
            best0 = compute_residual(problem, state.x, state.y)[0]
            return compiled_best_while(
                step1, state, target, max_steps, best0,
                stall_window=option.get("sweep_stall_window"),
                track_best_state=option.get("keep_best_point", False),
            )

        return solve

    # ------------------------------------------------------------------
    def solve_compiled(self, problem, max_steps: int, return_done: bool = False):
        """Fixed-budget solve over the lanes of a state.

        The JAX package compiles this loop into one ``lax.while_loop``; the
        port's counterpart is ``base.compiled_best_while``, eagerly a Python
        loop over device tensors with one host check of "every lane done"
        per step, under tracing (``experiment/export_artifact.py``) one
        ``while_loop`` operator.  Returns solve(state) -> (state, steps [B]); with
        ``return_done`` also each lane's stop flag [B], which tells "met its
        stopping criterion" from "ran out of ``max_steps``" (a segmented
        sweep needs it: a lane can stop on a segment's last step)."""
        inner = self._solve_loop(problem, max_steps)

        def solve(state):
            st, k, done, _ = inner(state, -math.inf)
            return (st, k, done) if return_done else (st, k)

        return solve

    # ------------------------------------------------------------------
    def solve_compiled_traced(self, problem, max_steps: int):
        """Fixed-budget solve that also records a per-step trace of every
        lane, so a batched sweep keeps its residual trajectories.

        Returns solve(state) -> (state, steps [B], trace): a dict of
        [B, max_steps] tensors ``residual``, ``mu``, ``cost`` (NaN past a
        lane's stop) and ``inner_status``, ``outer_iter`` (int32, -1 past
        it).  The stop rule is ``_solve_loop``'s at target -inf; the loop
        keeps one host check a step."""
        option = self.option
        step = make_step(problem, option, callbacks=False)
        tolresid = option["tolresid"]
        maxiter = option["maxiter"]

        def solve(state):
            b, dev, dt = state.mu.shape[0], state.mu.device, state.mu.dtype
            trace = {name: torch.full((b, max_steps), math.nan, dtype=dt, device=dev)
                     for name in ("residual", "mu", "cost")}
            trace |= {name: torch.full((b, max_steps), -1, dtype=torch.int32, device=dev)
                      for name in ("inner_status", "outer_iter")}
            k = torch.zeros(b, dtype=torch.int64, device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            lane = torch.arange(b, device=dev)
            for _ in range(max_steps):
                if bool(done.all()):
                    break
                new_state, info = step(state)
                row = {"residual": info["residual"], "mu": info["mu"], "cost": info["cost"],
                       "inner_status": info["inner_status"].to(torch.int32),
                       "outer_iter": new_state.outer_iter.to(torch.int32)}
                live = lane[~done]
                col = k[~done]
                for name, buf in trace.items():
                    buf[live, col] = row[name][~done].to(buf.dtype)
                stop = (info["converged"] & (info["residual"] <= tolresid)) | (
                    new_state.outer_iter >= maxiter)
                state = base.select_lanes(done, state, new_state)
                k = k + (~done).to(k.dtype)
                done = done | stop
            return state, k, trace

        return solve

    # ------------------------------------------------------------------
    def solve_compiled_best(self, problem, max_steps: int):
        """Fixed-budget solve tracking the protocol metric: the best KKT
        residual over inner-converged steps.  Returns solve(state, target)
        -> (state, steps, best); a lane also stops once its best <= target."""
        inner = self._solve_loop(problem, max_steps)

        def solve(state, target):
            st, k, _, best = inner(state, target)
            return st, k, best

        return solve

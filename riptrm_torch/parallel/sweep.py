"""Batched multi-start sweeps over the lane axis.

Counterpart of ``riptrm_tpu/parallel/sweep.py``: ``init_state_from``,
``batched_riptrm_solve``, the solver-generic sweeps of all four solvers
(``batched_solver_sweep``, ``batched_protocol_sweep``, ``protocol_single``,
through ``_solver_plumbing``), ``batched_ripm_continue`` and
``certify_second_order``.  The JAX package ``vmap``s a per-lane
``lax.while_loop``; here the solver state carries the lanes and one
lane-batched step runs them in lockstep, a finished lane frozen at its
stop.  With ``use_fused_tcg`` every step's tCG is one launch of a batched
kernel against the shared Zs: K3 on NonnegPCA, the Stiefel-bound kernel on
BoundedPCA.  ``certify_second_order`` certifies a batch of final points.
Meshes, sharding and staged precision (``staged_precision_ripm_solve``
among them) wait for ROADMAP.md queue 1 item 7.

The JAX package's ``_warn_vmapped_lanczos`` is not ported: under ``vmap``
the tCG mode's Lanczos certificate runs on every step of every lane, but
the port's step runs it only on steps where some lane's first-order tests
hold.
"""

from __future__ import annotations

import dataclasses

import torch

from riptrm_torch.ops.kkt import compute_residual
from riptrm_torch.ops.spectrum import lanczos
from riptrm_torch.solvers.riptrm import RIPTRM, RiptrmState, _barrier_ops, init_state


def _batched_exact_defaults(option):
    """Exact-mode default of the batched sweeps: ``exact_trs_method``
    'ms' unless the caller set it.  A sweep's lanes rarely all hit the
    cache on one step, so the cached eigendecomposition that makes 'eigh'
    cheap in single-lane runs is recomputed on most steps; the Moré-Sorensen
    TRS needs none.  ('auto' keeps the dim-256 crossover for single-lane
    runs.)"""
    if (option and option.get("TRS_solver") == "Exact_RepMat"
            and "exact_trs_method" not in option):
        option = dict(option)
        option["exact_trs_method"] = "ms"
    return option


def _widen(state, lanes):
    """A one-lane solver state repeated over ``lanes`` lanes."""
    return type(state)(**{
        f.name: getattr(state, f.name).expand(lanes, *getattr(state, f.name).shape[1:]).clone()
        for f in dataclasses.fields(state)
    })


def init_state_from(problem, option, x0, y0) -> RiptrmState:
    """RIPTRM initial state at arbitrary starts: ``x0`` [B, n] or [B, n, p],
    ``y0`` [B, m].  One unbatched start (``y0`` [m]) becomes one lane."""
    if y0.ndim == 1:
        x0, y0 = x0[None], y0[None]
    base = _widen(init_state(problem, option), x0.shape[0])
    return dataclasses.replace(base, x=x0, y=y0, inner_x0=x0, inner_y0=y0)


def batched_riptrm_solve(problem, option, max_steps: int):
    """Fixed-budget RIPTRM solve over stacked starts.

    Returns a function (xs0 [B, n] or [B, n, p], ys0 [B, m]) -> (final state,
    steps [B], residuals [B]).  Lanes run in lockstep to the slowest; each lane stops,
    and is frozen, at its own stopping point."""
    solver = RIPTRM(_batched_exact_defaults(option))
    solve = solver.solve_compiled(problem, max_steps)

    def run(xs0, ys0):
        state, k = solve(init_state_from(problem, solver.option, xs0, ys0))
        res = compute_residual(problem, state.x, state.y)[0]
        return state, k, res

    return run


def _solver_plumbing(problem, solver_name: str, option, max_steps: int):
    """Shared per-solver setup of the solver-generic sweeps.

    Returns (solve, start, resid_args): ``solve(st0, *extras, target) ->
    (state, steps, best)`` is the solver's best-tracking fixed-budget loop,
    ``start(xs0, ys0) -> (st0, extras)`` builds the lanes' initial state
    from starts [B, ...] and [B, m], and ``resid_args(st) -> (x, ineq_mult,
    eq_mult)`` gives the KKT-residual arguments in the solver's
    convention."""
    from riptrm_torch.solvers import ralm, ripm, rsqo

    if solver_name == "RIPTRM":
        solver = RIPTRM(_batched_exact_defaults(option))
        solve = solver.solve_compiled_best(problem, max_steps)

        def start(x0, y0):
            return init_state_from(problem, solver.option, x0, y0), ()

        def resid_args(st):
            return st.x, st.y, None

    elif solver_name == "RIPM":
        solve = ripm.solve_compiled_best(problem, option, max_steps)
        opt = ripm.RIPM(option).option

        def start(x0, y0):
            base, _, _ = ripm.init_state(problem, opt)
            base = _widen(base, x0.shape[0])
            phi0 = ripm._phi(problem, x0, *ripm._kkt_field(problem, x0, base.y, y0, y0))
            sigma0, rho0, tau_1, tau_2 = ripm._centring(y0, y0, phi0, problem.num_ineq)
            st0 = dataclasses.replace(base, x=x0, z=y0, s=y0, phi=phi0, sigma=sigma0, rho=rho0)
            return st0, (tau_1, tau_2)

        def resid_args(st):
            return st.x, st.z, st.y

    elif solver_name == "RSQO":
        solve = rsqo.solve_compiled_best(problem, option, max_steps)
        opt = rsqo.RSQO(option).option

        def start(x0, y0):
            base = _widen(rsqo.init_state(problem, opt), x0.shape[0])
            return dataclasses.replace(base, x=x0, y=y0), ()

        def resid_args(st):
            return st.x, st.y, st.z

    elif solver_name == "RALM":
        solve = ralm.solve_compiled_best(problem, option, max_steps)
        opt = ralm.RALM(option).option

        def start(x0, y0):
            base = _widen(ralm.init_state(problem, opt), x0.shape[0])
            return dataclasses.replace(base, x=x0, y=y0, y_unbd=y0), ()

        def resid_args(st):
            return st.x, st.y, st.z

    else:
        raise ValueError(f"Unknown solver {solver_name}")

    return solve, start, resid_args


def batched_solver_sweep(problem, solver_name: str, option, max_steps: int):
    """Fixed-budget solve of any of the four solvers over stacked starts.

    Returns a function (xs0 [B, ...], ys0 [B, m]) -> (x_final, ineq
    multipliers, steps [B], residuals [B])."""
    solve, start, resid_args = _solver_plumbing(problem, solver_name, option, max_steps)

    def run(xs0, ys0):
        st0, extras = start(xs0, ys0)
        st, k, _ = solve(st0, *extras, -float("inf"))
        x, ineq, eq = resid_args(st)
        return x, ineq, k, compute_residual(problem, x, ineq, eq)[0]

    return run


def batched_protocol_sweep(problem, solver_name: str, option, max_steps: int):
    """Time-to-target solves over stacked starts: like
    ``batched_solver_sweep``, but each lane carries its best residual and
    stops once it reaches its own ``target``.

    Returns a function (xs0, ys0, targets [B]) -> (x, ineq multipliers,
    steps [B], best [B])."""
    solve, start, resid_args = _solver_plumbing(problem, solver_name, option, max_steps)

    def run(xs0, ys0, targets):
        st0, extras = start(xs0, ys0)
        st, k, best = solve(st0, *extras, targets)
        x, ineq, _ = resid_args(st)
        return x, ineq, k, best

    return run


def protocol_single(problem, solver_name: str, option, max_steps: int):
    """The time-to-target solve of one start (x0 [n] or [n, p], y0 [m],
    a number ``target``): ``batched_protocol_sweep`` on one lane, its
    results unbatched.  Returns a function (x0, y0, target) -> (x, ineq
    multipliers, steps, best)."""
    sweep = batched_protocol_sweep(problem, solver_name, option, max_steps)

    def run(x0, y0, target):
        target = torch.as_tensor(target, dtype=y0.dtype, device=y0.device).reshape(1)
        x, ineq, k, best = sweep(x0[None], y0[None], target)
        return x[0], ineq[0], k[0], best[0]

    return run


def batched_ripm_continue(problem, option, max_steps: int):
    """Fixed-budget RIPM solve continuing from prior final states
    (``RipmState`` over lanes): the iteration counter is re-seeded and the
    merit and centring scalars (phi, sigma, rho, tau_1, tau_2) recomputed
    under this problem, with ``keep_best_point`` on unless ``option`` says
    otherwise.  Returns a function (states) -> (state, steps [B],
    residuals [B])."""
    from riptrm_torch.solvers import ripm

    option = {"keep_best_point": True, **(option or {})}
    solve = ripm.solve_compiled_best(problem, option, max_steps)
    m = problem.num_ineq

    def run(st):
        phi = ripm._phi(problem, st.x, *ripm._kkt_field(problem, st.x, st.y, st.z, st.s))
        sigma, rho, tau_1, tau_2 = ripm._centring(st.z, st.s, phi, m)
        st = dataclasses.replace(st, phi=phi, sigma=sigma, rho=rho,
                                 iteration=torch.zeros_like(st.iteration))
        state, k, _ = solve(st, tau_1, tau_2, -float("inf"))
        return state, k, compute_residual(problem, state.x, state.z, state.y)[0]

    return run


def certificate_operator(problem, xs, ys, ratio_cap=None):
    """(hw, cx, feasible [B]): the condensed barrier Hessian Hw at each (x, y)
    that ``certify_second_order`` certifies, the start direction's gradient
    and the lanes on which a capped certificate is conservative.

    Hw does not depend on the barrier parameter (mu shifts only cx).
    ``ratio_cap`` clamps the barrier ratio w = y/c inside the PSD barrier
    term G diag(w) G' only; the Lagrangian term keeps the true multipliers,
    so Hw_true - Hw_capped is PSD and the capped certificate is
    conservative, at feasible points only (c > 0 everywhere): elsewhere a
    true weight is negative and w = 0 would over-report lambda_min."""
    if ratio_cap is None:
        _, hw, cx = _barrier_ops(problem, xs, ys, torch.zeros_like(ys[:, 0]))
        return hw, cx, torch.ones_like(ys[:, 0], dtype=torch.bool)
    c = problem.slack(xs)
    feasible = torch.amin(c, dim=-1) > 0
    pos = c > 0
    w = torch.where(pos, torch.clamp(ys / torch.where(pos, c, torch.ones_like(c)),
                                     max=ratio_cap), torch.zeros_like(c))
    lag_hvp = problem.lag_rhess_at(xs, ys)  # the TRUE y in the Lagrangian
    gx = problem.gx_at(xs)
    gx_adj = problem.gx_adj_at(xs)

    def hw(dx):
        return lag_hvp(dx) + gx(w * gx_adj(dx))

    return hw, problem.rgrad(xs), feasible


def certify_second_order(problem, xs, ys, *, num_iters=64, ratio_cap=None):
    """Post-hoc second-order certificates for a batch of final points
    (``xs`` [B, ...], ``ys`` [B, m]): one lane-batched Lanczos, the Ritz
    minimum of Hw at each lane [B], an upper bound converging to its
    lambda_min (the criterion RIPTRM's tCG mode checks in its loop).  Run a
    sweep with ``second_order_stationarity=False`` and certify its final
    points here.  ``ratio_cap`` (``certificate_operator``) keeps a deeply
    converged point's barrier weights y/c ~ 1/c from swamping the
    certificate with rounding; its certificates are NaN on infeasible lanes."""
    man = problem.manifold
    hw, cx, feasible = certificate_operator(problem, xs, ys, ratio_cap)
    # deterministic start; the projected all-ones direction keeps it nonzero
    # where the gradient vanishes
    v0 = cx + 0.1 * man.proj(xs, torch.ones_like(xs))
    _, _, ritz = lanczos(hw, v0, man.inner_at(xs),
                         min(num_iters, man.dim))
    return torch.where(feasible, ritz[:, 0], torch.full_like(ritz[:, 0], float("nan")))

"""Batched multi-start sweeps over the lane axis.

Counterpart of ``riptrm_tpu/parallel/sweep.py``: ``init_state_from``,
``batched_riptrm_solve`` and its continuation ``batched_riptrm_continue``,
the solver-generic sweeps of all four solvers (``batched_solver_sweep``,
``batched_protocol_sweep``, ``protocol_single``, through
``_solver_plumbing``), ``batched_ripm_continue``, the staged-precision
solves (``staged_precision_riptrm_solve``, ``staged_precision_riptrm_compacted``,
``staged_precision_ripm_solve``),
``run_sweep`` and the checkpointed segments (``make_segment_solver``,
``run_sweep_checkpointed``), ``instance_batched_riptrm`` and
``certify_second_order``.  The JAX package ``vmap``s a per-lane
``lax.while_loop``; here the solver state carries the lanes and one
lane-batched step runs them in lockstep, a finished lane frozen at its
stop.  With ``use_fused_tcg`` every step's tCG is the kernel the problem
gives (``Problem.fused_tcg_at``, ``problems/structured.py``).
``certify_second_order`` certifies a batch of final points.  The compacted
staged solve (``staged_precision_riptrm_compacted``) drives phase 2 from
the host, a segment at a time over the lanes still running.

Scale-out runs on ``torch.distributed``: ``make_mesh`` names the ranks'
axes (``{"dp": d}`` or ``{"dp": d, "tp": t}``), ``sharded_riptrm_solve``
(JAX: ``shard_map`` of the vmapped solve) runs each rank's B/d lanes and
all-gathers the residuals, and ``run_sweep`` and ``run_sweep_checkpointed``
take the mesh.  Every rank passes the whole batch of starts and takes its
own lanes.  A lane's solve runs no collective: ranks stop at different
steps, so the one collective of a solve comes after it (a segmented sweep
adds one ``all_reduce`` a segment, the count of lanes still running).

Under torch.profiler a call of ``batched_riptrm_solve``, ``batched_solver_sweep``
or ``run_sweep_checkpointed`` runs in a ``riptrm.sweep`` span, with
``riptrm.sweep.init`` and ``riptrm.sweep.residual`` beside its steps
(``utils/spans.py``); the sharded solve's lanes run in the span of the
``batched_riptrm_solve`` it calls.

The JAX package's ``_warn_vmapped_lanczos`` is not ported: under ``vmap``
the tCG mode's Lanczos certificate runs on every step of every lane, but
the port's step runs it only on steps where some lane's first-order tests
hold.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from riptrm_torch.ops import collectives
from riptrm_torch.ops.kkt import compute_residual
from riptrm_torch.ops.spectrum import lanczos
from riptrm_torch.parallel import distributed
from riptrm_torch.solvers.base import select_lanes
from riptrm_torch.solvers.riptrm import RIPTRM, RiptrmState, _barrier_ops, init_state
from riptrm_torch.utils.spans import span


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


def make_mesh(axis_sizes: dict, device=None):
    """A ``torch.distributed`` device mesh over the world's ranks, its axes
    named and sized by ``axis_sizes`` in order (``{"dp": d}`` or ``{"dp": d,
    "tp": t}``), on CUDA unless ``device`` says otherwise (``'cpu'`` for a
    gloo world of CPU processes).  The process group must exist
    (``parallel.distributed.initialize``) and the mesh must span it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[name]) for name in names)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call "
                           "riptrm_torch.parallel.distributed.initialize first")
    if math.prod(sizes) != dist.get_world_size():
        raise ValueError(f"make_mesh: mesh {dict(zip(names, sizes))} has {math.prod(sizes)} "
                         f"ranks, the world {dist.get_world_size()}")
    dev_type = "cuda" if device is None else torch.device(device).type
    return init_device_mesh(dev_type, sizes, mesh_dim_names=names)


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
        with span("riptrm.sweep"):
            with span("riptrm.sweep.init"):
                st0 = init_state_from(problem, solver.option, xs0, ys0)
            state, k = solve(st0)
            with span("riptrm.sweep.residual"):
                res = compute_residual(problem, state.x, state.y)[0]
            return state, k, res

    return run


def batched_riptrm_continue(problem, option, max_steps: int):
    """Fixed-budget RIPTRM solve continuing from prior final states
    (``RiptrmState`` over lanes), phase 2 of a staged-precision sweep: the
    outer and inner counters and the inner-reset anchors (x, y, radius) are
    re-seeded on every lane and the exact-mode cache invalidated (the new
    problem's matmul precision changes the materialisation), while mu and
    the trust region carry on.  ``keep_best_point`` is on unless ``option``
    says otherwise: the continuation works at the precision floor, where a
    lane must not hand back a state worse than its own best.  Returns a
    function (states) -> (state, steps [B], residuals [B])."""
    option = {"keep_best_point": True, **(option or {})}
    solver = RIPTRM(_batched_exact_defaults(option))
    solve = solver.solve_compiled(problem, max_steps)

    def run(st):
        st = dataclasses.replace(
            st,
            outer_iter=torch.zeros_like(st.outer_iter),
            inner_count=torch.zeros_like(st.inner_count),
            inner_x0=st.x,
            inner_y0=st.y,
            inner_tr0=st.tr_radius,
            cache_valid=torch.zeros_like(st.cache_valid),
        )
        state, k = solve(st)
        return state, k, compute_residual(problem, state.x, state.y)[0]

    return run


def staged_precision_riptrm_solve(problem_lo, problem_hi, option_lo, option_hi,
                                  max_steps: int):
    """Two-phase staged-precision batched solve: phase 1 runs
    ``problem_lo`` (e.g. ``matmul_precision='high'``, TF32 on CUDA) to its
    float32 floor, phase 2 continues every lane under ``problem_hi`` (e.g.
    'highest') with ``option_hi``'s tighter tolerances and forcing floors
    (``batched_riptrm_continue``).  The fused tCG kernels compute in FP32
    under either setting, so on the fused route the phases differ in their
    tolerances only.  Returns a function (xs0, ys0) -> (final states, total
    steps [B], phase-2 residuals [B], phase-1 residuals [B])."""
    s1 = batched_riptrm_solve(problem_lo, option_lo, max_steps)
    s2 = batched_riptrm_continue(problem_hi, option_hi, max_steps)

    def run(xs0, ys0):
        st1, k1, res1 = s1(xs0, ys0)
        st2, k2, res2 = s2(st1)
        return st2, k1 + k2, res2, res1

    return run


def _bucket(active_lanes: int, batch: int) -> int:
    """The power of two at or above ``active_lanes``, at most ``batch``."""
    return min(1 << max(0, math.ceil(math.log2(active_lanes))), batch)


def staged_precision_riptrm_compacted(problem_lo, problem_hi, option_lo, option_hi,
                                      max_steps: int, segment_steps: int = 100,
                                      stall_rtol: float = 1e-2):
    """Staged-precision solve with converged-lane compaction: phase 1 is
    ``batched_riptrm_solve`` under ``problem_lo``; phase 2 runs as
    host-driven segments of ``segment_steps`` steps of
    ``batched_riptrm_continue`` under ``problem_hi`` over the lanes still
    active, gathered into a batch of the next power of two (padded by
    repeating the first active lane, so at most log2(B) + 1 batch sizes
    occur; only the first occurrence of a lane is merged back).  A lane
    leaves the active set when its segment's residual reaches
    ``option_hi``'s ``tolresid`` (default 1e-6) or improves on its best by
    less than ``stall_rtol`` relative (floored); at most max_steps //
    segment_steps segments.  The continuation keeps each lane's best point
    unless ``option_hi`` says otherwise.

    Returns a host function run(xs0, ys0) -> (best phase-2 residuals [B],
    phase-1 residuals [B], segments each lane ran [B]), numpy arrays; the
    states stay on the device between segments."""
    option_hi = {"keep_best_point": True, **(option_hi or {})}
    s1 = batched_riptrm_solve(problem_lo, option_lo, max_steps)
    cont = batched_riptrm_continue(problem_hi, option_hi, segment_steps)
    tol = option_hi.get("tolresid", 1e-6)
    max_segments = max(1, max_steps // segment_steps)

    def run(xs0, ys0):
        st, _, res1 = s1(xs0, ys0)
        res1 = res1.cpu().numpy()
        batch = res1.shape[0]
        best = res1.copy()
        segments_used = np.zeros(batch, np.int64)
        active = np.ones(batch, bool)
        for _ in range(max_segments):
            if not active.any():
                break
            idx = np.nonzero(active)[0]
            pad = np.concatenate([idx, np.full(_bucket(len(idx), batch) - len(idx), idx[0])])
            rows = torch.as_tensor(idx, device=ys0.device)
            sub = _map_state(lambda a: a[torch.as_tensor(pad, device=ys0.device)], st)
            sub, _, res2 = cont(sub)
            st = type(st)(**{f.name: getattr(st, f.name).index_copy(
                0, rows, getattr(sub, f.name)[:len(idx)]) for f in dataclasses.fields(st)})
            now = res2.cpu().numpy()[:len(idx)]
            prev = best[idx]
            best[idx] = np.where(now < prev, now, prev)
            segments_used[idx] += 1
            floored = now > (1.0 - stall_rtol) * prev
            active[idx] = ~((now <= tol) | floored)
        return best, res1, segments_used

    return run


def _map_state(fn, st):
    """``fn`` on every field of a solver state."""
    return type(st)(**{f.name: fn(getattr(st, f.name)) for f in dataclasses.fields(st)})


def sharded_riptrm_solve(problem, option, max_steps: int, mesh, axis: str = "dp"):
    """``batched_riptrm_solve`` with the lanes split across ``mesh``'s axis
    ``axis``: rank i of d solves lanes [i B/d, (i+1) B/d) of the batch (B
    divisible by d), the ranks of other axes alike.

    Returns a function (xs0 [B, ...], ys0 [B, m], the whole batch on every
    rank) -> (x, y, steps: this rank's lanes [B/d, ...]; residuals: every
    lane's [B], all-gathered in lane order, the same on every rank).  No
    collective runs inside the step loop, where ranks stop at different
    steps; the residuals' all-gather follows the solve."""
    solve = batched_riptrm_solve(problem, option, max_steps)
    group, size, index = collectives.mesh_axis(mesh, axis)

    def run(xs0, ys0):
        lanes = collectives.shard_range(ys0.shape[0], size, index,
                                        f"sharded_riptrm_solve: lanes over {axis!r}")
        st, k, res = solve(xs0[lanes], ys0[lanes])
        return st.x, st.y, k, collectives.all_gather_cat(res, group)

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
        with span("riptrm.sweep"):
            with span("riptrm.sweep.init"):
                st0, extras = start(xs0, ys0)
            st, k, _ = solve(st0, *extras, -float("inf"))
            x, ineq, eq = resid_args(st)
            with span("riptrm.sweep.residual"):
                res = compute_residual(problem, x, ineq, eq)[0]
            return x, ineq, k, res

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


def staged_precision_ripm_solve(problem_lo, problem_hi, option_lo, option_hi,
                                max_steps: int):
    """Two-phase staged-precision batched RIPM solve, the RIPM counterpart
    of ``staged_precision_riptrm_solve``: phase 1 runs ``problem_lo`` to
    its floor, phase 2 continues every lane under ``problem_hi`` with
    ``option_hi`` (``batched_ripm_continue``).  Returns a function (xs0,
    ys0) -> (final states, total steps [B], phase-2 residuals [B], phase-1
    residuals [B])."""
    solve1, start1, _ = _solver_plumbing(problem_lo, "RIPM", option_lo, max_steps)
    cont = batched_ripm_continue(problem_hi, option_hi, max_steps)

    def run(xs0, ys0):
        st0, extras = start1(xs0, ys0)
        st1, k1, _ = solve1(st0, *extras, -math.inf)
        res1 = compute_residual(problem_lo, st1.x, st1.z, st1.y)[0]
        st2, k2, res2 = cont(st1)
        return st2, k1 + k2, res2, res1

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


def instance_batched_riptrm(option, max_steps: int, problem_builder=None):
    """Fixed-budget RIPTRM solve over problem instances x starts at once:
    lane b solves instance ``data[b]`` from ``xs0[b]``.

    ``problem_builder(data [B, ...], xs0 [B, ...]) -> Problem`` builds one
    problem over the B instances, its per-lane data lane-leading
    (``Problem.data``); the default is ``nonneg_pca.make_problem`` with
    data Z [B, n, n], and e.g. ``low_rank.make_problem`` takes A [B, m, n]
    with packed (U, S, V) starts.  With ``use_fused_tcg`` each lane's tCG
    is its own one-lane launch against its own Zs (K2 on the sphere, the
    Stiefel kernel at B = 1), never K3.  Returns a function (data, xs0,
    ys0 [B, m]) -> (x_final, y_final, steps [B], residuals [B])."""
    if problem_builder is None:
        from riptrm_torch.problems import nonneg_pca

        problem_builder = nonneg_pca.make_problem
    solver = RIPTRM(_batched_exact_defaults(option))

    def run(data, xs0, ys0):
        problem = problem_builder(data, xs0)
        solve = solver.solve_compiled(problem, max_steps)
        st, k = solve(init_state_from(problem, solver.option, xs0, ys0))
        return st.x, st.y, k, compute_residual(problem, st.x, st.y)[0]

    return run


def _as_lanes(problem, a):
    """``a`` as a tensor on the problem's device, in its dtype."""
    like = problem.y0
    if not isinstance(a, torch.Tensor):
        a = np.array(a)  # a writable copy (a JAX array's view is read-only)
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _as_stacked_points(problem, xs0):
    """Starts as one lane-leading tensor: a list of points stacks, and a
    tuple of lane-leading components (the JAX package's (J, R, Q) or
    (U, S, V) pytree points) is packed by ``manifold.pack`` into the port's
    layout."""
    if isinstance(xs0, list):
        return torch.stack([_as_lanes(problem, a) for a in xs0])
    if isinstance(xs0, tuple):
        return problem.manifold.pack(tuple(_as_lanes(problem, a) for a in xs0))
    return _as_lanes(problem, xs0)


def run_sweep(problem, option, xs0, ys0, *, max_steps=2000, mesh=None, axis="dp"):
    """Convenience wrapper: ``batched_riptrm_solve``, or with ``mesh``
    ``sharded_riptrm_solve`` over its axis ``axis`` with every result
    gathered, so each rank holds the whole sweep's.  Starts as arrays,
    lists or tuple points (``_as_stacked_points``).  Returns (x_final,
    y_final, steps [B], residuals [B])."""
    xs0, ys0 = _as_stacked_points(problem, xs0), _as_lanes(problem, ys0)
    if mesh is None:
        states, ks, res = batched_riptrm_solve(problem, option, max_steps)(xs0, ys0)
        return states.x, states.y, ks, res
    x, y, ks, res = sharded_riptrm_solve(problem, option, max_steps, mesh, axis)(xs0, ys0)
    group = collectives.mesh_axis(mesh, axis)[0]
    return (*(collectives.all_gather_cat(a, group) for a in (x, y, ks)), res)


def make_segment_solver(problem, option, segment_steps: int):
    """One checkpointable segment of a batched RIPTRM sweep.

    Returns a function (states, done [B]) -> (states, steps [B], residuals
    [B], done [B]) that runs at most ``segment_steps`` further steps a lane.
    A lane flagged ``done`` is frozen bit for bit and reports 0 steps (its
    target +inf is met by its starting residual, so it does not hold the
    others' loop either); the others' done-ness is the solve's own stop
    flag, not ``steps < segment_steps``, which cannot tell a lane that
    stopped on the segment's last step.  The state carries everything the
    solve resumes from (outer iteration, mu, trust region), so segments
    compose exactly."""
    solve = RIPTRM(_batched_exact_defaults(option))._solve_loop(problem, segment_steps)

    def run(states, done):
        target = torch.where(done, math.inf, -math.inf).to(states.mu.dtype)
        new, k, stopped, _ = solve(states, target)
        out = select_lanes(done, states, new)
        k = torch.where(done, torch.zeros_like(k), k)
        with span("riptrm.sweep.residual"):
            res = compute_residual(problem, out.x, out.y)[0]
        return out, k, res, done | stopped

    return run


# The identity of a sweep hashes the JAX package's option names and values,
# so both packages stamp one sweep alike: the port's options that have a JAX
# counterpart under another name enter under that name, options only the
# port has are left out, and options only the JAX package has enter at its
# defaults.  Both lists are empty while the defaults differ only by the
# renamed key (checked in tests/test_torch_sweep_api.py).
_JAX_OPTION_NAMES = {"use_fused_tcg": "use_pallas_tcg"}
_PORT_ONLY_OPTIONS = ()
_JAX_ONLY_DEFAULTS = {}


def _sweep_identity(problem, option, xs0, ys0) -> str:
    """Fingerprint of a checkpointed sweep's inputs: the starts (each
    component of a packed point, as the JAX package's tuple leaves), the
    non-callable solver options and the problem's dimensions.  A checkpoint
    resumed at the same path discards the caller's starts, so a checkpoint
    of another sweep with the same shapes must be refused.  The same
    starts, options and dimensions hash to the JAX function's bytes."""
    import hashlib

    h = hashlib.sha256()
    parts = problem.manifold.unpack(xs0)
    for leaf in (parts if isinstance(parts, tuple) else (parts,)) + (ys0,):
        arr = np.ascontiguousarray(leaf.detach().cpu().numpy())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    opts = {_JAX_OPTION_NAMES.get(k, k): v for k, v in option.items()
            if not callable(v) and k not in _PORT_ONLY_OPTIONS}
    opts = _JAX_ONLY_DEFAULTS | opts
    h.update(repr(sorted(opts.items(), key=lambda kv: kv[0])).encode())
    h.update(f"m={problem.num_ineq},dim={problem.manifold.dim}".encode())
    return h.hexdigest()[:16]


def _map_carry(fn, carry):
    """``fn`` on every per-lane tensor of a checkpointed sweep's carry."""
    return {"state": _map_state(fn, carry["state"]), "done": fn(carry["done"]),
            "ks": fn(carry["ks"])}


def run_sweep_checkpointed(problem, option, xs0, ys0, *, max_steps=2000, segment_steps=500,
                           checkpoint_path=None, mesh=None, axis="dp", meta=None,
                           on_segment=None):
    """Fault-tolerant batched sweep: the carry (every lane's solver state,
    its done flag and its steps) is checkpointed after each segment of
    ``segment_steps`` steps, and a rerun with the same ``checkpoint_path``
    resumes from the last completed segment, also from a checkpoint the JAX
    package wrote (``experiment/checkpoint.py`` reads its key names).

    The budget is exact: the last segment is truncated to ``max_steps``,
    and the steps done ride in the checkpoint's metadata (``steps_done``;
    an older checkpoint's ``segments_done`` x its ``segment_steps``), so a
    resume may take another segment size.  A checkpoint stamped by another
    sweep (``_sweep_identity``) is refused; one with no stamp resumes with
    a warning.  ``on_segment(segment, steps_done, residuals, done)`` is
    called on the host after each segment.

    With ``mesh`` the lanes are split across its axis ``axis``, as
    ``sharded_riptrm_solve`` splits them (every rank passes the whole
    batch).  Whether every lane is done is decided from one ``all_reduce``
    a segment, so every rank runs the same segments.  The checkpoint holds
    the whole carry, gathered after each segment and written by rank 0
    before a barrier, so a resume loads it whole and takes its own lanes,
    at any world size.  ``on_segment`` gets every lane's residuals and
    flags on every rank.  Returns (x_final, y_final, steps [B], residuals
    [B]), every lane's on every rank."""
    from riptrm_torch.experiment.checkpoint import load_state, save_state

    with span("riptrm.sweep"):
        xs0 = _as_stacked_points(problem, xs0)
        ys0 = _as_lanes(problem, ys0)
        solver = RIPTRM(_batched_exact_defaults(option))
        batch, dev = ys0.shape[0], ys0.device
        with span("riptrm.sweep.init"):
            carry = {
                "state": init_state_from(problem, solver.option, xs0, ys0),
                "done": torch.zeros(batch, dtype=torch.bool, device=dev),
                "ks": torch.zeros(batch, dtype=torch.int64, device=dev),
            }
        sweep_id = _sweep_identity(problem, solver.option, xs0, ys0)
        start_meta = {}
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            carry, start_meta = load_state(checkpoint_path, carry, manifold=problem.manifold)
            saved_id = start_meta.get("sweep_id")
            if saved_id is not None and saved_id != sweep_id:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was saved by a DIFFERENT sweep (sweep_id "
                    f"{saved_id} != {sweep_id}): refusing to resume, which would discard the "
                    "caller's xs0/ys0/option; use a fresh checkpoint_path (or delete the file)")
            if saved_id is None:
                import warnings

                warnings.warn(
                    f"resuming legacy checkpoint {checkpoint_path} with no sweep identity "
                    "stamp: the caller's xs0/ys0 are ignored in favor of the checkpointed state",
                    stacklevel=2)
        steps_done = int(start_meta.get(
            "steps_done",
            start_meta.get("segments_done", 0) * start_meta.get("segment_steps", segment_steps)))
        n_seg = int(start_meta.get("segments_done", 0))

        if mesh is None:
            def whole(t):
                return t

            def running(done):
                return not bool(done.all())
        else:
            group, size, index = collectives.mesh_axis(mesh, axis)
            lanes = collectives.shard_range(batch, size, index,
                                            f"run_sweep_checkpointed: lanes over {axis!r}")
            carry = _map_carry(lambda t: t[lanes], carry)

            def whole(t):
                return collectives.all_gather_cat(t, group)

            def running(done):
                return int(collectives.all_sum((~done).sum(), group)) > 0

        segments = {}  # at most two lengths: segment_steps and the truncated last
        res = None
        while steps_done < max_steps and running(carry["done"]):
            length = min(segment_steps, max_steps - steps_done)
            if length not in segments:
                segments[length] = make_segment_solver(problem, option, length)
            states, ks, res, done = segments[length](carry["state"], carry["done"])
            carry = {"state": states, "done": done, "ks": carry["ks"] + ks}
            steps_done += length
            n_seg += 1
            if checkpoint_path is not None:
                full = carry if mesh is None else _map_carry(whole, carry)
                if mesh is None or distributed.rank() == 0:
                    save_state(checkpoint_path, full, dict(meta or {}, segments_done=n_seg,
                                                           steps_done=steps_done,
                                                           sweep_id=sweep_id))
                if mesh is not None:
                    distributed.barrier()
            if on_segment is not None:
                on_segment(n_seg, steps_done, whole(res).cpu().numpy(),
                           whole(done).cpu().numpy())
        st = carry["state"]
        if res is None:  # a resumed finished sweep, or a zero budget
            with span("riptrm.sweep.residual"):
                res = compute_residual(problem, st.x, st.y)[0]
        return whole(st.x), whole(st.y), whole(carry["ks"]), whole(res)

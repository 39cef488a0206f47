"""Batched multi-start sweeps over the lane axis.

Counterpart of ``riptrm_tpu/parallel/sweep.py::init_state_from`` and
``batched_riptrm_solve``.  The JAX package ``vmap``s a per-lane
``lax.while_loop``; here the solver state carries the lanes and one
lane-batched step runs them in lockstep, a finished lane frozen at its
stop.  With ``use_fused_tcg`` every step's tCG is one launch of a batched
kernel against the shared Zs: K3 on NonnegPCA, the Stiefel-bound kernel on
BoundedPCA.  Meshes, sharding and staged precision
wait for ROADMAP.md queue 1 item 13.
"""

from __future__ import annotations

import dataclasses

from riptrm_torch.ops.kkt import compute_residual
from riptrm_torch.solvers.riptrm import RIPTRM, RiptrmState, init_state


def init_state_from(problem, option, x0, y0) -> RiptrmState:
    """RIPTRM initial state at arbitrary starts: ``x0`` [B, n] or [B, n, p],
    ``y0`` [B, m].  One unbatched start (``y0`` [m]) becomes one lane."""
    if y0.ndim == 1:
        x0, y0 = x0[None], y0[None]
    base = init_state(problem, option)
    lanes = x0.shape[0]
    widened = {
        f.name: getattr(base, f.name).expand(lanes, *getattr(base, f.name).shape[1:]).clone()
        for f in dataclasses.fields(base)
    }
    widened.update(x=x0, y=y0, inner_x0=x0, inner_y0=y0)
    return RiptrmState(**widened)


def batched_riptrm_solve(problem, option, max_steps: int):
    """Fixed-budget RIPTRM solve over stacked starts.

    Returns a function (xs0 [B, n] or [B, n, p], ys0 [B, m]) -> (final state,
    steps [B], residuals [B]).  Lanes run in lockstep to the slowest; each lane stops,
    and is frozen, at its own stopping point."""
    solver = RIPTRM(option)
    solve = solver.solve_compiled(problem, max_steps)

    def run(xs0, ys0):
        state, k = solve(init_state_from(problem, solver.option, xs0, ys0))
        res = compute_residual(problem, state.x, state.y)[0]
        return state, k, res

    return run

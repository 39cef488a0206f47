"""RIPTRM in tCG mode through ``parallel/sweep.py::batched_riptrm_solve``:
a fixed-budget solve of a batch of starts in lockstep, each lane frozen at
its own stop.  At one lane it is ``RIPTRM.solve_compiled`` on one start
(with the fused tCG, K2); at B lanes the batched kernel (K3, K4)."""

from __future__ import annotations


def option(problem, config, traffic):
    """The configuration's solver options with its float32 forcing
    floors: the Lagrangian floor, and a complementarity floor that grows
    like sqrt(m), calibrated at m = 200."""
    import torch

    f = config["forcing"]
    compl_floor = f["complementarity_floor_at_m200"] * max(1.0, (problem.num_ineq / 200.0) ** 0.5)
    lag_floor, factor = f["lagrangian_floor"], f["complementarity_factor"]
    return dict(config["solver"]) | {
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
        "use_fused_tcg": bool(traffic["fused_tcg"]),
        "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=lag_floor),
        "forcing_function_complementarity":
            lambda mu: torch.clamp(factor * mu, min=compl_floor),
    } | traffic.get("options", {})


def build(problem, config, traffic, max_steps):
    """(starts [B, ...], multipliers [B, m]) -> (answers, their multipliers,
    steps [B], the program's KKT residuals [B])."""
    from riptrm_torch.parallel.sweep import batched_riptrm_solve

    solve = batched_riptrm_solve(problem, option(problem, config, traffic), max_steps)

    def run(xs, ys):
        state, steps, residual = solve(xs, ys)
        return state.x, state.y, steps, residual

    return run

"""Any of the four solvers through ``parallel/sweep.py::batched_solver_sweep``
(the traffic mix names it): a fixed-budget solve of a batch of starts in
lockstep, each lane frozen at its own stop."""

from __future__ import annotations


def build(problem, config, traffic, max_steps):
    """(starts [B, ...], multipliers [B, m]) -> (answers, their inequality
    multipliers, steps [B], the program's KKT residuals [B])."""
    from riptrm_torch.parallel.sweep import batched_solver_sweep

    option = dict(config["solver"]) | traffic.get("options", {})
    return batched_solver_sweep(problem, traffic["solver"], option, max_steps)

"""The JAX package's float64 CPU results that ``chip_smoke.py`` phase 5e
holds the PyTorch port's card runs to (``GOLDEN_5E`` there).

    python scripts/torch_goldens.py [--port] [LABEL ...]

Runs each of phase 5e's solves with ``riptrm_tpu`` in float64 on the CPU
and prints, per run, the final residual and cost, the residual at the
close of each outer iteration (RIPTRM) or at each step (RIPM), and the
last second-order residual where the problem logs one; ``--port`` runs
the same solves with ``riptrm_torch`` on the CPU beside them; LABELs pick
runs by name.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the runs of phase 5e: (label, family, solver, option)
TCG = {"TRS_solver": "tCG", "second_order_stationarity": False}
RUNS = (
    ("sid_tcg", "sid", "RIPTRM", TCG | {"maxiter": 40, "tolresid": 1e-8}),
    ("rosenbrock_tcg", "rosenbrock", "RIPTRM", TCG | {"maxiter": 4, "tolresid": 1e-8}),
    ("rosenbrock_exact", "rosenbrock", "RIPTRM", {"maxiter": 40, "tolresid": 1e-6}),
    ("lowrank_tcg", "lowrank", "RIPTRM", TCG | {"maxiter": 40, "tolresid": 1e-8}),
    ("sid_ripm_jacobi", "sid", "RIPM", {"maxiter": 6, "tolresid": 1e-6,
                                        "KrylovIterMethod": True,
                                        "KrylovPreconditioner": "jacobi_theta"}),
)


def summary(log, solver):
    """(final residual, final cost, checkpoints, last second-order residual)."""
    if solver == "RIPTRM":
        marks = [r for s, r in zip(log["inner_status"], log["residual"]) if s == "converged"]
    else:
        marks = list(log["residual"])
    sor = log.get("second_order_residual")
    return (log["residual"][-1], log["cost"][-1], marks,
            None if sor is None else sor[-1])


def jax_runs():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from riptrm_tpu.problems import low_rank, rosenbrock, stable_identification
    from riptrm_tpu.solvers import ripm, riptrm

    probs = {"sid": lambda: stable_identification.load_problem(
                 "dataset/StableIdentification/1", "a"),
             "rosenbrock": lambda: rosenbrock.make_problem(5, 3),
             "lowrank": lambda: low_rank.load_problem("dataset/LowRank/1", "a")}
    solvers = {"RIPTRM": riptrm.RIPTRM, "RIPM": ripm.RIPM}
    return probs, solvers


def port_runs():
    import torch

    from riptrm_torch.problems import low_rank, rosenbrock, stable_identification
    from riptrm_torch.solvers import RIPM, RIPTRM

    kw = dict(dtype=torch.float64, device="cpu")
    probs = {"sid": lambda: stable_identification.load_problem(
                 "dataset/StableIdentification/1", "a", **kw),
             "rosenbrock": lambda: rosenbrock.make_problem(5, 3, **kw),
             "lowrank": lambda: low_rank.load_problem("dataset/LowRank/1", "a", **kw)}
    return probs, {"RIPTRM": RIPTRM, "RIPM": RIPM}


def main(argv):
    os.chdir(ROOT)
    packages = [("jax", jax_runs())]
    if "--port" in argv:
        packages.append(("port", port_runs()))
    labels = [a for a in argv if not a.startswith("--")]
    for label, family, solver, option in RUNS:
        if labels and label not in labels:
            continue
        for name, (probs, solvers) in packages:
            out = solvers[solver]({"maxtime": 600} | option).run(probs[family]())
            res, cost, marks, sor = summary(out.log, solver)
            print(f"{label} [{name}]: residual {res!r}, cost {cost!r}, "
                  f"second_order_residual {sor!r}, rows {len(out.log['residual'])}")
            print(f"  checkpoints {[float(f'{m:.10g}') for m in marks]}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""Analysis CLI: render the reference's notebook figures from CSV logs.

    python -m riptrm_torch.experiment.analyze --problem NonnegPCA \
        [--instance 1] [--initialpoints a,b,...] [--budget 240]

Reads ``intermediate/<problem>/<instance>/<point>/*_log.csv`` (what
``python -m riptrm_torch.experiment.simulate`` writes by default) and
writes the figures under ``result/torch/<problem>/``, beside, never over,
the JAX package's ``result/<problem>/``.  Needs matplotlib; runs on the
host only.
"""

from __future__ import annotations

import os
import sys

from riptrm_torch.experiment.analyzer import (
    box_plot_best_residuals,
    plot_residual_curves,
    plot_second_order_curves,
)
from riptrm_torch.experiment.cfg import maybe_help


def _discover_solvers(output_dir: str):
    if not os.path.isdir(output_dir):
        return []
    return sorted(f[: -len("_log.csv")] for f in os.listdir(output_dir)
                  if f.endswith("_log.csv"))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    maybe_help(argv, __doc__)
    problem = "NonnegPCA"
    instance = "1"
    initialpoints = ["a"]
    budget = 240.0
    it = iter(argv)
    for a in it:
        if a == "--problem":
            problem = next(it)
        elif a == "--instance":
            instance = next(it)
        elif a == "--initialpoints":
            initialpoints = next(it).split(",")
        elif a == "--budget":
            budget = float(next(it))
        else:
            raise SystemExit(f"unknown arg {a}")

    result_dir = f"result/torch/{problem}"
    os.makedirs(result_dir, exist_ok=True)
    root = f"intermediate/{problem}"

    first_dir = f"{root}/{instance}/{initialpoints[0]}"
    solvers = _discover_solvers(first_dir)
    if not solvers:
        raise SystemExit(f"no *_log.csv under {first_dir}; run the simulator first")

    path = f"{result_dir}/residual_{instance}_{initialpoints[0]}.png"
    plot_residual_curves(first_dir, solvers, save_path=path, budget=budget)
    print(f"wrote {path}")

    if problem == "Rosenbrock":
        path = f"{result_dir}/second_order_{instance}_{initialpoints[0]}.png"
        plot_second_order_curves(first_dir, solvers, save_path=path, budget=budget)
        print(f"wrote {path}")

    if len(initialpoints) > 1:
        path = f"{result_dir}/box_{instance}.png"
        _, data = box_plot_best_residuals(root, instance, initialpoints, solvers,
                                          save_path=path, budget=budget)
        print(f"wrote {path}")
        for k, v in data.items():
            print(f"  {k}: {len(v)} points")


if __name__ == "__main__":
    main()

"""Full paper-protocol benchmark sweep.

Counterpart of ``riptrm_tpu/experiment/benchmark.py``: runs the problems x
instances x initial points x solver grid of the shipped configs under the
reference protocol (240 s budget, maxiter 10000, min-KKT-residual metric)
through the host runners (``Simulator``), sharded across host processes
(``parallel/distributed.py::host_shard``), restartable through
``skip_existing``, and summarises each job's best residual within the
budget.

    python -m riptrm_torch.experiment.benchmark [--budget 240] [--problems A,B]
        [--solvers RIPTRM,...] [--scale 1.0] [--summary PATH] [--device cpu]
        [key=value ...]

``--scale`` shrinks the wall-clock budget for smoke runs (e.g. 0.05 ->
12 s per solve).  The summary goes to ``result/benchmark_summary_torch.json``
by default: the tracked ``result/benchmark_summary.json`` is the JAX
package's, and ``protocol_speedrun`` reads it as its targets.  float64 on
CUDA device 0 unless ``--device cpu``; raises without CUDA otherwise.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from riptrm_torch.experiment.analyzer import best_residual_within, filter_riptrm_rows, load_log
from riptrm_torch.experiment.cfg import maybe_help, sweep_configs, take_device
from riptrm_torch.experiment.simulator import Simulator
from riptrm_torch.parallel.distributed import host_shard

PROBLEMS = ["NonnegPCA", "Rosenbrock", "StableIdentification"]


def jobs_for(problem: str, overrides):
    return sweep_configs(f"configs/{problem}/config_simulation.yaml", overrides)


def _next_arg(it, flag):
    try:
        return next(it)
    except StopIteration:
        raise SystemExit(f"{flag} requires a value") from None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    maybe_help(argv, __doc__)
    dtype, device = take_device(argv)  # float64; raises without CUDA
    budget = 240.0
    problems = PROBLEMS
    solvers = None
    scale = 1.0
    summary_path = "result/benchmark_summary_torch.json"
    extra = []
    it = iter(argv)
    for a in it:
        if a == "--budget":
            budget = float(_next_arg(it, a))
        elif a == "--problems":
            problems = _next_arg(it, a).split(",")
        elif a == "--solvers":
            solvers = _next_arg(it, a).split(",")
        elif a == "--scale":
            scale = float(_next_arg(it, a))
        elif a == "--summary":
            summary_path = _next_arg(it, a)
        else:
            extra.append(a)

    budget_eff = budget * scale
    summary = {}
    for problem in problems:
        overrides = list(extra) + [
            f"solver_option.common.maxtime={budget_eff}",
            "skip_existing=true",
        ]
        if solvers:
            overrides.append(f"solver_name=[{','.join(solvers)}]")
        for cfg in host_shard(jobs_for(problem, overrides)):
            Simulator(cfg, dtype=dtype, device=device).run()
            out_dir = cfg.get_path("output_path")
            for f in sorted(os.listdir(out_dir)):
                if not f.endswith("_log.csv"):
                    continue
                name = f[: -len("_log.csv")]
                log = load_log(out_dir, name)
                if name.startswith("RIPTRM"):
                    log = filter_riptrm_rows(log)
                key = f"{problem}/{cfg.problem_instance}/{cfg.problem_initialpoint}/{name}"
                summary[key] = best_residual_within(log, budget_eff)

    os.makedirs(os.path.dirname(summary_path) or ".", exist_ok=True)
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    for k in sorted(summary):
        v = summary[k]
        print(f"{k}: best residual {v:.3e}" if np.isfinite(v) else f"{k}: n/a")
    return summary


if __name__ == "__main__":
    main()

"""Time-to-reference-target speedrun of the full paper protocol.

Counterpart of ``riptrm_tpu/experiment/protocol_speedrun.py``.  The
reference scores each (problem, instance, initial point, solver) job by the
least KKT residual reached within a 240 s budget.  This CLI measures how
fast the port's batched solvers reach those SAME residuals: every job's
target is the best residual the JAX package's full-budget host-protocol run
reached (``result/benchmark_summary.json``, its reference-parity numbers),
times ``--slack``; each (problem, instance, solver) group runs as ONE
``parallel/sweep.py::batched_protocol_sweep`` whose lanes stop at their own
targets, and lanes it misses are re-run one at a time
(``rescue_missed_lanes``).  The report compares the total wall time with the
reference's ``240 s x jobs`` budget.

    python -m riptrm_torch.experiment.protocol_speedrun
        [--problems NonnegPCA,...] [--summary result/benchmark_summary.json]
        [--out result/protocol_speedrun_torch.json] [--slack 1.0]
        [--max-steps 50000] [--solvers RIPTRM,...] [--option key=value]
        [--device cpu]

Runs float64 (the targets go down to 5e-16) on CUDA device 0 unless
``--device cpu``; raises without CUDA otherwise.  RIPM's
``checkNTequation`` self-check is off (diagnostic logging, not part of the
solve); RSQO takes the deep-parity QP settings ('lu', no warm start).
Time is a host clock around each synchronised group run.  Each group first
runs one step (``warmup_s``, reported apart from ``run_s`` as the JAX
package reports its compile time; the kernels' build, with
``--option use_fused_tcg=true``, happens before either).  RIPTRM's groups on
NonnegPCA and Rosenbrock get post-hoc second-order certificates
(``certify_second_order``).  The JAX package's reports are the tracked
``result/protocol_speedrun*.json``; the port's default output is
``result/protocol_speedrun_torch.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

PROBLEMS = ["NonnegPCA", "Rosenbrock", "StableIdentification"]
REFERENCE_BUDGET_S = 240.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stack_points(cfgs, *, dtype=None, device=None):
    """Per-point problems -> (problem, stacked x0s [B, ...], stacked y0s
    [B, m], point names)."""
    from riptrm_torch.experiment.registry import build_problem

    problems = [build_problem(c, dtype=dtype, device=device) for c in cfgs]
    xs0 = torch.stack([p.x0 for p in problems])
    ys0 = torch.stack([p.y0 for p in problems])
    return problems[0], xs0, ys0, [str(c.problem_initialpoint) for c in cfgs]


def rescue_missed_lanes(problem, solver_name, option, max_steps, xs0, ys0, targets, best_h,
                        ks_h):
    """One-lane rescue pass for the lanes the batched sweep misses.

    Lanes with ``best > target`` are re-run alone
    (``parallel.sweep.protocol_single``): batched lanes see other float64
    summation orders, and at chaotic accept/reject plateaus that can tip a
    trajectory away from the host's.  Mutates ``best_h``/``ks_h`` in place
    (each lane keeps its better result) and returns (rescued flags, run
    seconds); the rescue's time counts toward the group's run time.  A
    one-lane group is not re-run: its sweep already was that program."""
    from riptrm_torch.parallel.sweep import protocol_single

    rescued = [False] * len(targets)
    missed = [i for i, (b, t) in enumerate(zip(best_h, targets))
              if not (b <= t) and np.isfinite(t) and t > 0.0]
    if not missed or len(targets) == 1:
        return rescued, 0.0
    single = protocol_single(problem, solver_name, option, max_steps)
    _sync(xs0.device)
    t0 = time.perf_counter()
    for i in missed:
        _, _, k1, b1 = single(xs0[i], ys0[i], targets[i])
        b1 = float(b1)
        if b1 < best_h[i]:
            best_h[i] = b1
            ks_h[i] = int(k1)
        rescued[i] = True
    _sync(xs0.device)
    return rescued, time.perf_counter() - t0


def parse_option(kv: str):
    """``key=value`` -> (key, bool, int, float or str value)."""
    k, _, v = kv.partition("=")
    lv = v.lower()
    if lv in ("true", "false"):
        return k, lv == "true"
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def _next_arg(it, flag):
    try:
        return next(it)
    except StopIteration:
        raise SystemExit(f"{flag} requires a value") from None


def run_group(problem, solver_name, option, max_steps, xs0, ys0, targets):
    """One (problem, instance, solver) group: a one-step warm-up, then the
    timed batched protocol sweep and its rescue pass.  Returns (x, y,
    best, steps, rescued, run_s, warmup_s)."""
    from riptrm_torch.parallel.sweep import batched_protocol_sweep

    device = xs0.device
    targets_t = torch.tensor(targets, dtype=torch.float64, device=device)
    warm = batched_protocol_sweep(problem, solver_name, option, 1)
    _sync(device)
    t0 = time.perf_counter()
    warm(xs0, ys0, targets_t)
    _sync(device)
    warmup_s = time.perf_counter() - t0

    fn = batched_protocol_sweep(problem, solver_name, option, max_steps)
    t0 = time.perf_counter()
    x, y, ks, best = fn(xs0, ys0, targets_t)
    best_h = best.cpu().tolist()
    ks_h = ks.cpu().tolist()
    run_s = time.perf_counter() - t0  # ends in the host copies above
    rescued, rescue_s = rescue_missed_lanes(problem, solver_name, option, max_steps, xs0, ys0,
                                            targets, best_h, ks_h)
    return x, y, best_h, ks_h, rescued, run_s + rescue_s, warmup_s


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from riptrm_torch.experiment.cfg import (
        maybe_help,
        solver_options_from_cfg,
        sweep_configs,
        take_device,
    )

    maybe_help(argv, __doc__)
    dtype, device = take_device(argv)  # float64; raises without CUDA
    problems = PROBLEMS
    summary_path = "result/benchmark_summary.json"
    out_path = "result/protocol_speedrun_torch.json"
    slack = 1.0
    max_steps = 50_000
    solver_filter = None
    option_overrides = {}
    it = iter(argv)
    for a in it:
        if a == "--problems":
            problems = _next_arg(it, a).split(",")
        elif a == "--summary":
            summary_path = _next_arg(it, a)
        elif a == "--out":
            out_path = _next_arg(it, a)
        elif a == "--slack":
            slack = float(_next_arg(it, a))
        elif a == "--max-steps":
            max_steps = int(_next_arg(it, a))
        elif a == "--solvers":
            solver_filter = set(_next_arg(it, a).split(","))
        elif a == "--option":
            # key=value applied to every solver option dict (A/B studies,
            # e.g. --solvers RIPTRM --option use_fused_tcg=true)
            k, v = parse_option(_next_arg(it, a))
            option_overrides[k] = v
        else:
            raise SystemExit(f"unknown arg {a}")

    from riptrm_torch.experiment.registry import SOLVERS
    from riptrm_torch.parallel.sweep import certify_second_order

    if option_overrides.get("use_fused_tcg") and device.type == "cuda":
        from riptrm_torch.ops import _build

        _build.load()  # the kernels' build, before any clock
    with open(summary_path) as f:
        targets_by_key = json.load(f)

    report = {"groups": {}}
    total_run_s = 0.0
    total_warmup_s = 0.0
    n_jobs = 0

    def flush():
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)

    for problem_name in problems:
        all_cfgs = sweep_configs(f"configs/{problem_name}/config_simulation.yaml")
        # Group by instance: each instance is its own problem data and its
        # own target keys (lanes batch over initial points only).
        by_instance: dict = {}
        for c in all_cfgs:
            by_instance.setdefault(str(c.problem_instance), []).append(c)
        for instance, cfgs in by_instance.items():
            problem, xs0, ys0, points = stack_points(cfgs, dtype=dtype, device=device)
            cfg0 = cfgs[0]
            for solver_name in cfg0.solver_name:
                if solver_filter and solver_name not in solver_filter:
                    continue
                option = solver_options_from_cfg(cfg0, solver_name)
                option.pop("maxtime", None)  # fixed budget: no wall clock
                option["checkNTequation"] = False
                if solver_name == "RSQO":
                    # Deep-parity QP settings: the condensed-Cholesky
                    # warm-started QP perturbs each QP solution within its
                    # tolerance, and over 10^4 SQP steps that plateaus
                    # lanes far above the 3.3e-15 reference floor that LU +
                    # cold start reach.
                    option["quadoptim_linear_solver"] = "lu"
                    option["quadoptim_warm_start"] = False
                option.update(option_overrides)
                decorated = SOLVERS[solver_name](option).name
                targets, missing = [], []
                for pt in points:
                    key = f"{problem_name}/{instance}/{pt}/{decorated}"
                    t = targets_by_key.get(key)
                    if t is None or not np.isfinite(t):
                        missing.append(key)
                        t = 0.0  # run the full schedule; reported as a miss
                    targets.append(float(t) * slack)
                if missing:
                    print(f"WARNING: no finite target for {len(missing)} job(s) (e.g. "
                          f"{missing[0]}); those lanes run the full maxiter schedule",
                          flush=True)

                x, y, best_h, ks_h, rescued, run_s, warmup_s = run_group(
                    problem, solver_name, option, max_steps, xs0, ys0, targets)
                group = {
                    "points": points,
                    "targets": targets,
                    "best": [float(b) for b in best_h],
                    "steps": [int(k) for k in ks_h],
                    "reached": [bool(b <= t) for b, t in zip(best_h, targets)],
                    "rescued": rescued,
                    "missing_targets": missing,
                    "run_s": run_s,
                    "warmup_s": warmup_s,
                }
                if solver_name == "RIPTRM" and problem_name in ("NonnegPCA", "Rosenbrock"):
                    # Post-hoc second-order certificates at every final
                    # point, for AFFINE-constraint problems only: there
                    # Hess g = 0, so the ratio-capped certificate is
                    # meaningful (StableIdentification's clipped terminal
                    # duals make any such bound vacuous).
                    mineigs = certify_second_order(problem, x, y, ratio_cap=1e8)
                    group["second_order_mineig"] = [float(v) for v in mineigs.cpu()]
                report["groups"][f"{problem_name}/{instance}/{decorated}"] = group
                total_run_s += run_s
                total_warmup_s += warmup_s
                n_jobs += len(points)
                flush()  # a killed run keeps its partials
                print(f"{problem_name}/{instance}/{decorated}: {len(points)} jobs in "
                      f"{run_s:.3f}s (warm-up {warmup_s:.2f}s), "
                      f"{sum(group['reached'])}/{len(points)} targets reached", flush=True)

    ref_total = REFERENCE_BUDGET_S * n_jobs
    if device.type == "cuda":
        from riptrm_torch.utils.devices import name_and_power_limit

        card = name_and_power_limit()
    else:
        card = "cpu"
    report["total"] = {
        "jobs": n_jobs,
        "reached": sum(sum(g["reached"]) for g in report["groups"].values()),
        "run_s": total_run_s,
        "warmup_s": total_warmup_s,
        "reference_budget_s": ref_total,
        "run_fraction_of_reference": total_run_s / ref_total if ref_total else None,
        "run_plus_warmup_fraction": ((total_run_s + total_warmup_s) / ref_total
                                     if ref_total else None),
        "device": card,
    }
    flush()
    print(json.dumps(report["total"]), flush=True)
    return report


if __name__ == "__main__":
    main()

"""The reference's configured 10-instance NonnegPCA sweep, end to end.

Counterpart of ``riptrm_tpu/experiment/paper_sweep.py``.  The reference
runs this sweep as 10 independent Hydra-multirun OS processes (one
simulation a ``dataset/NonnegPCA/<i>`` instance); here the whole sweep is
ONE lane-batched solve, ``parallel/sweep.py::instance_batched_riptrm``,
with each instance's Z the data of its lane:

    python -m riptrm_torch.experiment.paper_sweep              # CUDA device 0
    python -m riptrm_torch.experiment.paper_sweep --device cpu # float64 CPU

On the CPU the sweep runs in float64 at the reference's tolresid 1e-15; on
the card in float32 at tolresid 2e-4 with the float32 forcing floors and
``matmul_precision='high'`` (TF32, scoped to the problem's operators), the
JAX module's two configurations.  The tCG is the plain ``truncated_cg``,
as there.

Writes ``result/NonnegPCA_instance_sweep_torch.json`` (the JAX file's keys;
``--out`` elsewhere) and an analyzer-style box plot of the log10 final
residuals, ``result/torch/NonnegPCA_instance_boxplot.png`` (``--plot``),
where matplotlib is installed.  The instances must exist: the JAX module
generates missing ones, but the port's generators draw other streams, so a
missing instance is refused by name.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
N_INSTANCES = 10
INITIALPOINTS = ("a",)  # the reference's configured list
DATASET = REPO / "dataset" / "NonnegPCA"
OUT = REPO / "result" / "NonnegPCA_instance_sweep_torch.json"
PLOT = REPO / "result" / "torch" / "NonnegPCA_instance_boxplot.png"


def load_batch(root, instances, dtype, device):
    """The instances' (Z, x0, y0) stacked over lanes (instance x initial
    point), with their labels; raises ``FileNotFoundError`` naming the
    first missing instance."""
    from riptrm_torch.utils.io import loadtxt

    zs, xs, ys, labels = [], [], [], []
    for i in range(1, instances + 1):
        d = pathlib.Path(root) / str(i)
        if not (d / "Z.csv").exists():
            raise FileNotFoundError(
                f"NonnegPCA instance {i} is missing ({d / 'Z.csv'}): the port does not "
                "generate the reference's instances (its generators draw other streams); "
                "copy or generate dataset/NonnegPCA/{1..10} first")
        dim = int(np.atleast_1d(loadtxt(str(d / "dim.csv")))[0])
        z = loadtxt(str(d / "Z.csv")).reshape(dim, dim)
        for pt in INITIALPOINTS:
            zs.append(z)
            xs.append(loadtxt(str(d / f"initx_{pt}.csv")).reshape(dim))
            ys.append(np.atleast_1d(loadtxt(str(d / "initineqLagmult.csv"))).reshape(dim))
            labels.append(f"{i}/{pt}")
    kw = dict(dtype=dtype, device=device)
    return (torch.tensor(np.stack(zs), **kw), torch.tensor(np.stack(xs), **kw),
            torch.tensor(np.stack(ys), **kw), labels)


def sweep_config(device):
    """(dtype, option, matmul_precision) of the JAX module's CPU or device
    configuration."""
    option = {"maxiter": 10_000, "TRS_solver": "tCG", "second_order_stationarity": False}
    if device.type == "cpu":
        return torch.float64, option | {"tolresid": 1e-15}, None
    return torch.float32, option | {
        "tolresid": 2e-4,
        "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
        "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-4),
    }, "high"


def plot(res, device_name, path):
    """The box plot of log10 final residuals; skipped with a message where
    matplotlib is missing (the card has none)."""
    try:
        import matplotlib
    except ImportError:
        print(f"paper_sweep: matplotlib is not installed; no plot at {path}", file=sys.stderr)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(4.5, 4))
    ax.boxplot([np.log10(np.maximum(res, 1e-300))], tick_labels=["RIPTRM (tCG, batched)"])
    ax.set_ylabel("log10 final KKT residual")
    ax.set_title(f"NonnegPCA 10-instance sweep ({device_name})")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return str(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA device 0; 'cpu' for the float64 CPU "
                             "configuration)")
    parser.add_argument("--max-steps", type=int, default=2000)
    parser.add_argument("--budget", type=float, default=240.0,
                        help="per-job reference wall budget (s), reported against the sweep's "
                             "wall time")
    parser.add_argument("--dataset", default=str(DATASET),
                        help="directory holding the instances 1..--instances")
    parser.add_argument("--instances", type=int, default=N_INSTANCES)
    parser.add_argument("--out", default=str(OUT))
    parser.add_argument("--plot", default=str(PLOT), help="box plot path ('' for none)")
    args = parser.parse_args(argv)

    from riptrm_torch.config import resolve
    from riptrm_torch.parallel.sweep import instance_batched_riptrm
    from riptrm_torch.problems import nonneg_pca

    _, device = resolve(None, args.device)  # raises without CUDA
    dtype, option, precision = sweep_config(device)
    zs, xs0, ys0, labels = load_batch(args.dataset, args.instances, dtype, device)

    def builder(z, xs):
        return nonneg_pca.make_problem(z, xs, matmul_precision=precision)

    def timed(max_steps):
        solve = instance_batched_riptrm(option, max_steps, problem_builder=builder)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = solve(zs, xs0, ys0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    _, warmup_s = timed(1)  # a one-step run pays the one-time costs
    (_, _, ks, res), solve_wall = timed(args.max_steps)
    res = res.cpu().numpy().astype(float)
    ks = ks.cpu().numpy().astype(int)

    if device.type == "cuda":
        from riptrm_torch.utils.devices import name_and_power_limit

        device_name = name_and_power_limit()
    else:
        device_name = "cpu"
    out = {
        "problem": "NonnegPCA",
        "instances": args.instances,
        "initialpoints": list(INITIALPOINTS),
        "device": device_name,
        "dtype": str(dtype).replace("torch.", ""),
        "jobs": {lab: {"residual": float(r), "steps": int(k)}
                 for lab, r, k in zip(labels, res, ks)},
        "median_residual": float(np.median(res)),
        "max_residual": float(np.max(res)),
        # the JAX key: there the first run's compile and solve; here a
        # one-step warm-up run and the solve
        "compile_plus_solve_s": warmup_s + solve_wall,
        "solve_s": solve_wall,
        "reference_budget_s": args.budget * len(labels),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    plotted = plot(res, device_name, args.plot) if args.plot else None
    print(json.dumps({
        "jobs": len(labels),
        "median_residual": out["median_residual"],
        "max_residual": out["max_residual"],
        "solve_s": out["solve_s"],
        "vs_reference_budget": out["solve_s"] / out["reference_budget_s"],
        "device": device_name,
        "plot": plotted,
    }))
    return out


if __name__ == "__main__":
    main()

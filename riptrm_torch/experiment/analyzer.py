"""Analysis layer: plots + strict-complementarity checks from the CSV logs.

Counterpart of ``riptrm_tpu/experiment/analyzer.py`` (the reference's
notebooks ``src/*/analyzer.ipynb`` and
``StableIdentification/analyzer_strict_complementarity.py``):

* residual-vs-time curves with the RIPTRM row convention (only
  ``inner_status in {converged, initial/NaN}`` — NonnegPCA analyzer cell 5)
* second-order-residual curves with arctan squashing (Rosenbrock cell 5)
* per-initial-point box plots of the best log10 residual within the
  wall-clock budget (StableIdentification cell 5)
* strict-complementarity flagging (|y_i| and |g_i(x)| both <= tol)

A log is read with the ``csv`` module into a dict of numpy columns (a
column whose every cell is a number is float64 with NaN for an empty cell,
any other an object array with None for it), so the numeric functions need
no pandas; matplotlib is imported inside the plot functions only.  Colors
follow the Paul Tol colorblind-safe palette used by the reference.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, List, Optional

import numpy as np

# Paul Tol bright palette (reference NonnegPCA analyzer cell 3)
TOL_COLORS = ["#4477AA", "#EE6677", "#228833", "#CCBB44", "#66CCEE", "#AA3377", "#BBBBBB"]

DISPLAY_NAMES = {
    "RIPTRM_tCG": "RIPTRM (tCG)",
    "RIPTRM_Exact_RepMat": "RIPTRM (exact)",
    "RALM_SteepestDescent": "RALM",
    "RSQO_reghess_corr1e-02": "RSQO ($\\delta$=1e-2)",
    "RSQO_reghess_corr1e-04": "RSQO ($\\delta$=1e-4)",
}


def _column(cells):
    try:
        return np.array([float(c) if c != "" else np.nan for c in cells], dtype=np.float64)
    except ValueError:
        return np.array([c if c != "" else None for c in cells], dtype=object)


def read_table(path: str) -> Dict[str, np.ndarray]:
    """A CSV with a header row -> {column: numpy array}."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {h: _column([r[i] for r in body]) for i, h in enumerate(header)}


def select(table: Dict[str, np.ndarray], mask) -> Dict[str, np.ndarray]:
    """The rows of ``table`` where ``mask`` holds."""
    return {k: v[mask] for k, v in table.items()}


def load_log(output_dir: str, solver_name: str) -> Dict[str, np.ndarray]:
    return read_table(f"{output_dir}/{solver_name}_log.csv")


def _is_missing(col):
    if col.dtype == object:
        return np.array([v is None or (isinstance(v, float) and v != v) for v in col],
                        dtype=bool)
    return np.isnan(col)


def filter_riptrm_rows(log):
    """Keep only outer-converged (+ initial) rows for RIPTRM logs — the
    analyzers' plotted-iteration convention (BASELINE.md)."""
    if "inner_status" not in log:
        return log
    col = log["inner_status"]
    keep = _is_missing(col) | np.isin(col.astype(object), ["converged", "initial"])
    return select(log, keep)


def best_residual_within(log, budget: float = 240.0) -> float:
    """The least residual of the rows at time <= budget (NaN rows skipped);
    NaN when there is none."""
    res = log["residual"][log["time"] <= budget]
    res = res[~np.isnan(res)]
    return float(res.min()) if len(res) else float("nan")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, save_path):
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150)


def _budget_log(output_dir, name, budget):
    log = load_log(output_dir, name)
    if name.startswith("RIPTRM"):
        log = filter_riptrm_rows(log)
    return select(log, log["time"] <= budget)


def plot_residual_curves(
    output_dir: str,
    solver_names: Iterable[str],
    save_path: Optional[str] = None,
    budget: float = 240.0,
    value: str = "residual",
    logy: bool = True,
):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, name in enumerate(solver_names):
        log = _budget_log(output_dir, name, budget)
        ax.plot(log["time"], log[value], label=DISPLAY_NAMES.get(name, name),
                color=TOL_COLORS[i % len(TOL_COLORS)])
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("KKT residual" if value == "residual" else value)
    ax.legend()
    _save(fig, save_path)
    return fig


def plot_second_order_curves(
    output_dir: str,
    solver_names: Iterable[str],
    save_path: Optional[str] = None,
    budget: float = 240.0,
):
    """Second-order residual curves, arctan-squashed (Rosenbrock cell 5)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, name in enumerate(solver_names):
        log = _budget_log(output_dir, name, budget)
        ax.plot(log["time"], np.arctan(log["second_order_residual"]),
                label=DISPLAY_NAMES.get(name, name), color=TOL_COLORS[i % len(TOL_COLORS)])
    ax.axhline(0.0, color="gray", lw=0.5)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("arctan(second-order residual)")
    ax.legend()
    _save(fig, save_path)
    return fig


def best_residuals(
    intermediate_root: str,
    instance,
    initialpoints: Iterable[str],
    solver_names: Iterable[str],
    budget: float = 240.0,
) -> Dict[str, List[float]]:
    """{display name: [log10 best residual within budget, one per initial
    point with a log]} (the box plot's data)."""
    data: Dict[str, List[float]] = {}
    for name in solver_names:
        vals = []
        for pt in initialpoints:
            path = f"{intermediate_root}/{instance}/{pt}"
            try:
                log = load_log(path, name)
            except FileNotFoundError:
                continue
            if name.startswith("RIPTRM"):
                log = filter_riptrm_rows(log)
            v = best_residual_within(log, budget)
            if np.isfinite(v) and v > 0:
                vals.append(float(np.log10(v)))
        data[DISPLAY_NAMES.get(name, name)] = vals
    return data


def box_plot_best_residuals(
    intermediate_root: str,
    instance,
    initialpoints: Iterable[str],
    solver_names: Iterable[str],
    save_path: Optional[str] = None,
    budget: float = 240.0,
):
    """Box plots of log10 best residual within budget over initial points
    (StableIdentification cell 5)."""
    data = best_residuals(intermediate_root, instance, initialpoints, solver_names, budget)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.boxplot(list(data.values()), tick_labels=list(data.keys()))
    ax.set_ylabel("log10 best KKT residual within budget")
    plt.setp(ax.get_xticklabels(), rotation=20, ha="right")
    _save(fig, save_path)
    return fig, data


def strict_complementarity(problem, x, y, tol: float = 1e-8):
    """Indices where both |y_i| and |g_i(x)| are <= tol — strict
    complementarity violations
    (``analyzer_strict_complementarity.py:51-68``).  ``x`` is one point (a
    tensor, or a tuple of components that ``problem.manifold.pack`` packs),
    ``y`` its multipliers [m]."""
    import torch

    like = problem.y0
    if isinstance(x, (tuple, list)):
        x = problem.manifold.pack(tuple(torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                                        device=like.device) for a in x))
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    g = problem.ineq_val(x[None])[0].detach().cpu().numpy()
    y = np.asarray(y.detach().cpu() if hasattr(y, "detach") else y)
    return np.where((np.abs(y) <= tol) & (np.abs(g) <= tol))[0]


def check_strict_complementarity_outputs(
    dataset_path: str,
    intermediate_root: str,
    instance,
    initialpoints: Iterable[str],
    solver_names: Iterable[str],
    tol: float = 1e-8,
    *,
    device=None,
):
    """Post-check saved outputs for all (solver, initial point) pairs of a
    StableIdentification instance, float64 on ``device`` (default CUDA
    device 0).  Returns {(solver, point): violated index array}."""
    import torch

    from riptrm_torch.experiment.simulator import load_block_file
    from riptrm_torch.problems import stable_identification as si

    results = {}
    for pt in initialpoints:
        problem = si.load_problem(dataset_path, pt, dtype=torch.float64, device=device)
        for name in solver_names:
            out_dir = f"{intermediate_root}/{instance}/{pt}"
            x_path = f"{out_dir}/{name}_x.csv"
            y_path = f"{out_dir}/{name}_ineqLagmult.csv"
            if not (os.path.exists(x_path) and os.path.exists(y_path)):
                continue
            with open(x_path) as f:
                first = f.readline()
            if first.startswith("# block"):
                x = tuple(load_block_file(x_path))
            else:
                x = np.loadtxt(x_path)
            y = np.loadtxt(y_path)
            results[(name, pt)] = strict_complementarity(problem, x, y, tol)
    return results

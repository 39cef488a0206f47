"""Simulation pipeline: coordinator -> solver(s) -> CSV persistence.

Counterpart of ``riptrm_tpu/experiment/simulator.py`` (the reference's
``base_simulator.py`` and the per-problem ``simulator.py`` overrides).
Output files are keyed by the solver's decorated ``output.name`` (e.g.
``RIPTRM_tCG_log.csv``), which the analyzers depend on:
``<output_path>/<name>_{x,ineqLagmult,eqLagmult,option,log}.csv``.  The
tables are written with the ``csv`` module in the JAX package's pandas
layout: the same columns in the same order, an empty cell for None, a
numeric column's cells as pandas prints them.  A point of a product or
fixed-rank manifold (one packed tensor in the port) is unpacked by
``manifold.unpack`` and written in the ``# block r c`` format.

CLI (CUDA device 0 by default, raising without CUDA; ``--device cpu`` for
the CPU; float64 unless ``--dtype float32``):
    python -m riptrm_torch.experiment.simulate --config configs/NonnegPCA/config_simulation.yaml
    python -m riptrm_torch.experiment.simulate --problem NonnegPCA [-m] [key=value ...] \
        [--device cpu] [--dtype float32]
"""

from __future__ import annotations

import csv
import logging
import os
import sys

import numpy as np
import torch

from riptrm_torch.experiment.cfg import (
    Config,
    load_config,
    maybe_help,
    solver_options_from_cfg,
    sweep_configs,
    take_device,
)

logger = logging.getLogger(__name__)


def _kind(v):
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    return "other"


def _float_cell(v) -> str:
    v = float(v)
    return "" if v != v else repr(v)


def _column_cells(values) -> list:
    """A column's cells as pandas' ``DataFrame(...).to_csv`` writes them:
    an all-number column with a float in it is float64 (ints print as
    ``3.0``), an int column prints ints, a bool column True/False, any
    other mix is an object column printed cell by cell."""
    kinds = {_kind(v) for v in values}
    if kinds == {"int"}:
        return [str(int(v)) for v in values]
    if kinds <= {"int", "float"}:
        return [_float_cell(v) for v in values]
    if kinds == {"bool"}:
        return [str(bool(v)) for v in values]
    return [_float_cell(v) if _kind(v) == "float" else str(v) for v in values]


def write_table(path: str, table: dict) -> None:
    """A dict of equal-length columns as a CSV with a header row."""
    lengths = {len(v) for v in table.values()}
    if len(lengths) > 1:
        raise ValueError("All arrays must be of the same length")
    cols = [_column_cells(v) for v in table.values()]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(table))
        for row in zip(*cols):
            w.writerow(row)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_output(output_path: str, name: str, output, manifold=None) -> None:
    """Persist every Output attribute (``base_simulator.py:75-95``):
    ``<output_path>/<name>_{x,ineqLagmult,eqLagmult,option,log}.csv``.
    ``manifold`` unpacks the port's packed point of a product or
    fixed-rank manifold into its components (block format); a tuple or
    list value is written in blocks as it is."""
    os.makedirs(output_path, exist_ok=True)
    for attr in ("x", "ineqLagmult", "eqLagmult", "option", "log"):
        content = getattr(output, attr)
        path = f"{output_path}/{name}_{attr}.csv"
        if attr == "x" and manifold is not None and isinstance(content, torch.Tensor):
            content = manifold.unpack(content)
        if isinstance(content, dict):
            content = {k: (v if isinstance(v, list) else [v]) for k, v in content.items()}
            write_table(path, {k: ["" if vv is None else vv for vv in v]
                               for k, v in content.items()})
        elif isinstance(content, (tuple, list)):
            # product-manifold point: block format, one block per component
            with open(path, "w") as f:
                for block in content:
                    arr = np.atleast_2d(_host(block))
                    f.write(f"# block {arr.shape[0]} {arr.shape[1]}\n")
                    np.savetxt(f, arr)
        else:
            np.savetxt(path, np.atleast_1d(_host(content)))


def load_block_file(path: str):
    """Read the block format written by :func:`save_output` (the analog of
    the reference's ``analyzer_strict_complementarity.load_block_file``)."""
    blocks = []
    rows: list = []
    shape = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("# block"):
                if shape is not None:
                    blocks.append(np.asarray(rows).reshape(shape))
                parts = line.split()
                shape = (int(parts[2]), int(parts[3]))
                rows = []
            elif line:
                rows.append([float(v) for v in line.split()])
    if shape is not None:
        blocks.append(np.asarray(rows).reshape(shape))
    return blocks


class Simulator:
    """``base_simulator.Simulator`` equivalent, on ``device`` (default CUDA
    device 0) in ``dtype`` (default float64)."""

    def __init__(self, cfg: Config, *, dtype=None, device=None):
        for attr in (
            "problem_name",
            "problem_instance",
            "problem_initialpoint",
            "solver_name",
            "solver_option",
        ):
            if attr not in cfg:
                raise ValueError(f"config missing {attr}")
        self.cfg = cfg
        self.dtype, self.device = dtype, device

    def run(self):
        from riptrm_torch.experiment.checkpoint import job_is_done
        from riptrm_torch.experiment.registry import SOLVERS, build_problem

        cfg = self.cfg
        out_dir = cfg.get_path("output_path") or (
            f"intermediate/{cfg.problem_name}/{cfg.problem_instance}/"
            f"{cfg.problem_initialpoint}"
        )
        os.makedirs(out_dir, exist_ok=True)
        logger.info(
            "Running simulator -- instance: %s, initial point: %s",
            cfg.problem_instance,
            cfg.problem_initialpoint,
        )
        problem = build_problem(cfg, dtype=self.dtype, device=self.device)
        names = cfg.solver_name
        if isinstance(names, str):
            names = [names]
        skip_existing = bool(cfg.get_path("skip_existing", False))
        for name in names:
            option = solver_options_from_cfg(cfg, name)
            solver = SOLVERS[name](option)
            if skip_existing and job_is_done(out_dir, solver.name):
                logger.info("Skipping completed job %s", solver.name)
                continue
            logger.info("Running solver %s", solver.name)
            output = solver.run(problem)
            save_output(out_dir, output.name, output, manifold=problem.manifold)
            logger.info("Finished solver %s", solver.name)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    maybe_help(argv, __doc__)
    dtype, device = take_device(argv, with_dtype=True)  # raises without CUDA
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    multirun = False
    config_path = None
    overrides = []
    it = iter(argv)
    for a in it:
        if a in ("-m", "--multirun"):
            multirun = True
        elif a == "--config":
            config_path = next(it)
        elif a == "--problem":
            config_path = f"configs/{next(it)}/config_simulation.yaml"
        else:
            overrides.append(a)
    if config_path is None:
        raise SystemExit("usage: simulate (--config PATH | --problem NAME) [-m] [key=value ...]"
                         " [--device DEV] [--dtype float32|float64]")
    cfgs = sweep_configs(config_path, overrides) if multirun else [
        load_config(config_path, overrides)]
    for cfg in cfgs:
        Simulator(cfg, dtype=dtype, device=device).run()


if __name__ == "__main__":
    main()

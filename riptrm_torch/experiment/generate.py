"""Dataset generation pipeline.

Counterpart of ``riptrm_tpu/experiment/generate.py`` (the reference's
``dataset_generator.py`` and per-problem generators), over the port's
generators with ``torch.Generator`` streams seeded from the config's
``seed`` and the instance name (``_instance_seed``): one stream for the
instance, one per initial point.  The port's random streams are not JAX's,
so the instances it writes differ from the JAX-generated ones (the shipped
``dataset/`` files) in their draws, not in their distribution or layout.

The shipped configs write to ``dataset/${problem_name}/${instance_name}``,
which holds the tracked instances: the port refuses to write into an
instance directory that already has a ``dim.csv``, naming it, unless
``--overwrite`` is given.

CLI (CUDA device 0 by default, raising without CUDA; ``--device cpu`` for
the CPU):
    python -m riptrm_torch.experiment.generate --problem NonnegPCA [-m] [key=value ...] \
        [--device cpu] [--overwrite]
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import torch

from riptrm_torch.experiment.cfg import load_config, maybe_help, sweep_configs, take_device
from riptrm_torch.problems import bounded_pca, low_rank, nonneg_pca
from riptrm_torch.problems import stable_identification as si

logger = logging.getLogger(__name__)


def _save(outdir: str, name: str, arr) -> None:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    np.savetxt(f"{outdir}/{name}.csv", np.asarray(arr, dtype=float))


def _instance_seed(cfg) -> int:
    base = int(cfg.get_path("seed", 0) or 0)
    return base * 1000003 + int(cfg.instance_name)


def _generator(cfg, device, stream: int = 0) -> torch.Generator:
    """The instance's random stream ``stream`` (0: the instance; i + 1: its
    i-th initial point), on ``device``."""
    seed = int(np.random.SeedSequence([_instance_seed(cfg), stream]).generate_state(1)[0])
    return torch.Generator(device).manual_seed(seed)


def _outdir(cfg, overwrite: bool) -> str:
    """The instance directory, created; an existing instance (a ``dim.csv``)
    is refused unless ``overwrite``."""
    outdir = cfg.get_path("output_path") or f"dataset/{cfg.problem_name}/{cfg.instance_name}"
    if not overwrite and os.path.exists(f"{outdir}/dim.csv"):
        raise FileExistsError(
            f"{outdir} already holds an instance (dim.csv); pass --overwrite to replace it, "
            "or set output_path=<dir>"
        )
    os.makedirs(outdir, exist_ok=True)
    return outdir


def generate_nonneg_pca(cfg, device, overwrite=False):
    """``NonnegPCA/generator.py``: spiked Z + initial points + dual init."""
    outdir = _outdir(cfg, overwrite)
    kw = dict(dtype=torch.float64, device=device)
    dim = int(cfg.dim)
    data = nonneg_pca.generate_instance(_generator(cfg, device), dim, float(cfg.snr),
                                        float(cfg.delta), **kw)
    _save(outdir, "dim", [[dim]])
    _save(outdir, "Z", data["Z"])
    feasible = cfg.get_path("initialpoints_type", "feasible") == "feasible"
    for i, name in enumerate(cfg.initialpoints):
        x0 = nonneg_pca.generate_initialpoint(_generator(cfg, device, i + 1), dim, feasible,
                                              **kw)
        _save(outdir, f"initx_{name}", x0)
    _save(outdir, "initineqLagmult", np.ones(dim))


def generate_rosenbrock(cfg, device, overwrite=False):
    """``Rosenbrock/generator.py``: identity initial point + dual init."""
    outdir = _outdir(cfg, overwrite)
    dim = int(cfg.dim)
    _save(outdir, "dim", [[dim]])
    _save(outdir, "initx", np.eye(dim))
    _save(outdir, "initineqLagmult", np.ones(dim * dim))


def generate_stable_identification(cfg, device, overwrite=False):
    """``StableIdentification/generator.py``: true system, constraints,
    trajectories with AWGN, RALM-based interior initial points."""
    outdir = _outdir(cfg, overwrite)
    rng = np.random.default_rng(_instance_seed(cfg))
    gen = _generator(cfg, device)
    kw = dict(dtype=torch.float64, device=device)
    d = int(cfg.dim)
    scaling = float(cfg.get_path("scaling", 1.0))

    while True:
        try:
            J, R, Q, A = si.generate_true_system(gen, d, scaling, **kw)
            constset = si.generate_constraints(
                rng, d, A, float(cfg.oneboxratio), float(cfg.twoboxratio)
            )
            _save(outdir, "dim", [[d]])
            _save(outdir, "constset", constset)
            _save(outdir, "true_J", J)
            _save(outdir, "true_R", R)
            _save(outdir, "true_Q", Q)
            _save(outdir, "true_A", A)
            for xi in cfg.Xset:
                X, noisyX = si.generate_trajectory(
                    rng, d, A, float(cfg.h), int(cfg.N), float(cfg.snr)
                )
                _save(outdir, f"X_{xi}", X)
                _save(outdir, f"noisyX_{xi}", noisyX)
            m = sum(2 if int(r[0]) in (0, 1) else 1 for r in np.atleast_2d(constset))
            _save(outdir, "initineqLagmult", np.ones(m))
            ralm_option = dict(cfg.get_path("solver_option.common") or {})
            for i, name in enumerate(cfg.initialpoints):
                iJ, iR, iQ, iA = si.generate_interior_initialpoint(
                    gen,
                    d,
                    constset,
                    scaling=scaling,
                    interior_scaling=float(cfg.get_path("interior_scaling", 0.95)),
                    ralm_option=ralm_option,
                    **kw,
                )
                _save(outdir, f"initJ_{name}", iJ)
                _save(outdir, f"initR_{name}", iR)
                _save(outdir, f"initQ_{name}", iQ)
                _save(outdir, f"initA_{name}", iA)
            break
        except ValueError as e:  # retry loop (generator.py:18-55)
            logger.warning("retrying instance generation: %s", e)


def generate_low_rank(cfg, device, overwrite=False):
    """Nonnegative low-rank approximation on the fixed-rank manifold (the
    JAX package's extension family)."""
    outdir = _outdir(cfg, overwrite)
    kw = dict(dtype=torch.float64, device=device)
    m, n, k = int(cfg.m), int(cfg.n), int(cfg.rank)
    data = low_rank.generate_instance(_generator(cfg, device), m, n, k, float(cfg.noise),
                                      **kw)
    _save(outdir, "dim", [[m, n, k]])
    _save(outdir, "A", data["A"])
    lb = float(cfg.get_path("lb", 0.0) or 0.0)
    for i, name in enumerate(cfg.initialpoints):
        u0, s0, v0 = low_rank.generate_initialpoint(_generator(cfg, device, i + 1), m, n, k,
                                                    lb=lb, **kw)
        _save(outdir, f"initU_{name}", u0)
        _save(outdir, f"initS_{name}", s0)
        _save(outdir, f"initV_{name}", v0)
    _save(outdir, "initineqLagmult", np.ones(m * n))


def generate_bounded_pca(cfg, device, overwrite=False):
    """Bounded-coordinate PCA on Stiefel (the JAX package's extension
    family)."""
    outdir = _outdir(cfg, overwrite)
    kw = dict(dtype=torch.float64, device=device)
    n, p = int(cfg.dim), int(cfg.p)
    data = bounded_pca.generate_instance(_generator(cfg, device), n, float(cfg.snr),
                                         float(cfg.delta), **kw)
    bound = float(cfg.get_path("bound", 0.8) or 0.8)
    _save(outdir, "dim", [[n, p]])
    _save(outdir, "Z", data["Z"])
    for i, name in enumerate(cfg.initialpoints):
        x0 = bounded_pca.generate_initialpoint(_generator(cfg, device, i + 1), n, p,
                                               bound=bound, **kw)
        _save(outdir, f"initx_{name}", x0)
    _save(outdir, "initineqLagmult", np.ones(2 * n * p))


GENERATORS = {
    "NonnegPCA": generate_nonneg_pca,
    "Rosenbrock": generate_rosenbrock,
    "StableIdentification": generate_stable_identification,
    "LowRank": generate_low_rank,
    "BoundedPCA": generate_bounded_pca,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    maybe_help(argv, __doc__)
    _, device = take_device(argv)  # raises without CUDA
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    multirun = False
    overwrite = False
    config_path = None
    overrides = []
    it = iter(argv)
    for a in it:
        if a in ("-m", "--multirun"):
            multirun = True
        elif a == "--overwrite":
            overwrite = True
        elif a == "--config":
            config_path = next(it)
        elif a == "--problem":
            config_path = f"configs/{next(it)}/config_dataset.yaml"
        else:
            overrides.append(a)
    if config_path is None:
        raise SystemExit("usage: generate (--config PATH | --problem NAME) [-m] [key=value ...]"
                         " [--device DEV] [--overwrite]")
    cfgs = sweep_configs(config_path, overrides) if multirun else [
        load_config(config_path, overrides)]
    for cfg in cfgs:
        logger.info("Generating %s instance %s", cfg.problem_name, cfg.instance_name)
        GENERATORS[cfg.problem_name](cfg, device, overwrite)


if __name__ == "__main__":
    main()

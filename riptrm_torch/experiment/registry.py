"""Problem / solver registries.

Counterpart of ``riptrm_tpu/experiment/registry.py`` (the reference's
string -> ``importlib`` plugin mechanism, ``base_simulator.py:44-67``):
solvers and problem builders are looked up by the same config names
(``solver_name: ["RIPTRM", ...]``, ``problem_name: NonnegPCA``), over the
port's ``load_problem`` / ``make_problem``.
"""

from __future__ import annotations

from riptrm_torch.problems import bounded_pca, low_rank, nonneg_pca, rosenbrock
from riptrm_torch.problems import stable_identification as si
from riptrm_torch.solvers.ralm import RALM
from riptrm_torch.solvers.ripm import RIPM
from riptrm_torch.solvers.riptrm import RIPTRM
from riptrm_torch.solvers.rsqo import RSQO

SOLVERS = {
    "RIPTRM": RIPTRM,
    "RIPM": RIPM,
    "RSQO": RSQO,
    "RALM": RALM,
}


def build_problem(cfg, *, dtype=None, device=None):
    """Problem factory from a simulation config (the coordinator layer;
    reference ``src/<Problem>/coordinator.py``), with the JAX keys and
    defaults.  ``dtype``/``device`` default to float64 on CUDA device 0
    (``config.resolve``)."""
    name = cfg.problem_name
    dataset_path = f"dataset/{cfg.problem_name}/{cfg.problem_instance}"
    kw = dict(dtype=dtype, device=device)
    if name == "NonnegPCA":
        return nonneg_pca.load_problem(dataset_path, str(cfg.problem_initialpoint), **kw)
    if name == "Rosenbrock":
        return rosenbrock.make_problem(int(cfg.n), int(cfg.k), float(cfg.alpha), **kw)
    if name == "StableIdentification":
        return si.load_problem(
            dataset_path,
            str(cfg.problem_initialpoint),
            x_set=tuple(cfg.Xset),
            is_x_noisy=bool(cfg.is_X_noisy),
            h=float(cfg.h),
            **kw,
        )
    if name == "BoundedPCA":
        return bounded_pca.load_problem(
            dataset_path,
            str(cfg.problem_initialpoint),
            bound=float(cfg.get_path("bound", 0.8) or 0.8),
            **kw,
        )
    if name == "LowRank":
        return low_rank.load_problem(
            dataset_path,
            str(cfg.problem_initialpoint),
            lb=float(cfg.get_path("lb", 0.0) or 0.0),
            **kw,
        )
    raise ValueError(f"Unknown problem_name: {name}")

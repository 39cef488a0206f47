"""The PyTorch port imports without JAX."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
MODULES = [
    "riptrm_torch",
    "riptrm_torch.config",
    "riptrm_torch.manifolds",
    "riptrm_torch.problems",
    "riptrm_torch.ops",
    "riptrm_torch.ops.kernels",
    "riptrm_torch.ops.basis",
    "riptrm_torch.ops.spectrum",
    "riptrm_torch.ops.trs",
    "riptrm_torch.ops.conjres",
    "riptrm_torch.ops.qp",
    "riptrm_torch.solvers",
    "riptrm_torch.solvers.ripm",
    "riptrm_torch.solvers.rsqo",
    "riptrm_torch.solvers.ralm",
    "riptrm_torch.solvers.subsolvers",
    "riptrm_torch.manifolds.euclidean",
    "riptrm_torch.manifolds.grassmann",
    "riptrm_torch.manifolds.spd",
    "riptrm_torch.manifolds.product",
    "riptrm_torch.manifolds.fixed_rank",
    "riptrm_torch.ops.compensated",
    "riptrm_torch.problems.rosenbrock",
    "riptrm_torch.problems.stable_identification",
    "riptrm_torch.problems.embedded",
    "riptrm_torch.problems.low_rank",
    "riptrm_torch.parallel.sweep",
    "riptrm_torch.parallel",
    "riptrm_torch.utils",
    "riptrm_torch.utils.spans",
    "riptrm_torch.experiment",
    "riptrm_torch.experiment.roofline",
    "riptrm_torch.experiment.export_artifact",
    "riptrm_torch.experiment.cfg",
    "riptrm_torch.experiment.registry",
    "riptrm_torch.experiment.checkpoint",
    "riptrm_torch.experiment.simulator",
    "riptrm_torch.experiment.simulate",
    "riptrm_torch.experiment.generate",
    "riptrm_torch.experiment.analyzer",
    "riptrm_torch.experiment.analyze",
    "riptrm_torch.experiment.benchmark",
    "riptrm_torch.experiment.protocol_speedrun",
    "riptrm_torch.experiment.chip_sweep",
    "riptrm_torch.parallel.distributed",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    code = (
        f"import sys, {module}; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'riptrm_tpu'))); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_sources():
    for path in (REPO / "riptrm_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (
                words[:1] in (["import"], ["from"]) and len(words) > 1
                and words[1].split(".")[0] in ("jax", "riptrm_tpu")
            ), f"{path}: {line}"

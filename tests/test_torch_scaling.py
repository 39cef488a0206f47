"""The port's weak-scaling harness (``riptrm_torch/experiment/scaling.py``)
on the CPU, mirroring ``tests/test_scaling.py``, held against the JAX
package's harness and sweep on the same inputs in float64.

``sweep_rate`` runs here over a one-rank gloo mesh (the JAX test's dp = 2
mesh of virtual devices has no counterpart without a second process) on
the JAX test's instance, its starts replaced by the JAX harness's
(PRNGKey(11) draws); its median and max residual are the JAX ``sweep_rate``'s within
rtol 5e-2 (``tests/test_parallel.py``'s tolerance between two sweeps).
``measure`` starts a world of one process and one of two (gloo, one thread
each, every worker with its own 120 s timeout) on the port's own instance
and starts; each row's median and max residual are those of the JAX
package's ``run_sweep`` of the same instance and starts, within the same
rtol.  Every rank of the CPU shares the host, so the two-rank row reports
``shared_device`` and no efficiency.  The rates are host-clock rates of a
CPU: not a device number.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from riptrm_torch.experiment import scaling
from riptrm_torch.parallel import distributed as td
from riptrm_torch.parallel.sweep import make_mesh
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_tpu.experiment.scaling import sweep_rate as jsweep_rate
from riptrm_tpu.parallel.sweep import make_mesh as jmake_mesh
from riptrm_tpu.parallel.sweep import run_sweep as jrun_sweep
from riptrm_tpu.problems import nonneg_pca as jn

torch.set_num_threads(1)

# tests/test_parallel.py's tolerance between two sweeps of the same starts: in
# float64 the lanes stop within a step of each other near the forcing floor
N, MAX_STEPS, RTOL = 32, 200, 5e-2


def _jax_option():
    """The harness's options, with its forcing floors in JAX."""
    option = {k: v for k, v in scaling.option().items() if not callable(v)}
    return option | {
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": lambda mu: jnp.maximum(1e-3 * mu, 2e-4),
    }


@pytest.fixture(scope="module")
def jax_harness():
    """The JAX test's instance (Z, x0), the JAX harness's starts of a batch
    of 4 (its PRNGKey(11) draws, as ``sweep_rate`` makes them) and the
    (median, max) residual of its ``sweep_rate`` over dp = 2, float64."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    z = np.asarray(jn.generate_instance(k1, N)["Z"])
    x0 = np.abs(np.asarray(jax.random.normal(k2, (N,))))
    x0 = x0 / np.linalg.norm(x0)
    problem = jn.make_problem(z, x0, dtype=jnp.float64)
    xs0 = jnp.abs(jax.random.normal(jax.random.PRNGKey(11), (4, N), dtype=jnp.float64))
    xs0 = np.array(xs0 / jnp.linalg.norm(xs0, axis=1, keepdims=True))
    _, med, mx = jsweep_rate(problem, _jax_option(), jmake_mesh({"dp": 2}, jax.devices()[:2]),
                             batch=4, max_steps=MAX_STEPS, reps=(1, 2), tries=1)
    return z, x0, xs0, (med, mx)


def test_sweep_rate_runs_and_converges(tmp_path, jax_harness, monkeypatch):
    z, x0, xs0, (jmed, jmx) = jax_harness
    monkeypatch.setattr(scaling, "starts", lambda problem, batch: (
        torch.tensor(xs0), torch.ones(batch, N, dtype=torch.float64)))
    td.initialize(f"file://{tmp_path / 'rv'}", 1, 0, device="cpu")
    try:
        mesh = make_mesh({"dp": 1}, "cpu")
        problem = tn.make_problem(z, x0, dtype=torch.float64, device="cpu")
        rate, med, mx = scaling.sweep_rate(problem, scaling.option(), mesh, batch=4,
                                           max_steps=MAX_STEPS, tries=2)
    finally:
        dist.destroy_process_group()
    assert rate > 0
    assert np.isfinite(med) and np.isfinite(mx)
    assert mx < 1e-3  # every lane reaches near the requested tolerance
    np.testing.assert_allclose([med, mx], [jmed, jmx], rtol=RTOL)


def test_measure_weak_scaling_rows():
    rows = scaling.measure([1, 2], per_rank=2, n=N, max_steps=MAX_STEPS, tries=1,
                           device="cpu", dtype="float64")
    assert [r["ranks"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0 and not rows[0]["shared_device"]
    assert rows[1]["batch"] == 4
    assert rows[1]["solves_per_sec"] > 0
    # two processes on one host share its cores: no weak-scaling claim
    assert rows[1]["shared_device"] and rows[1]["efficiency"] is None
    problem = scaling.make_instance(N, dtype=torch.float64, device="cpu")
    jp = jn.make_problem(problem.structure["Zs"].numpy(), problem.x0.numpy(), dtype=jnp.float64)
    for r in rows:
        assert r["device"] == "cpu" and r["backend"] == "gloo"
        assert np.isfinite(r["median_residual"]) and r["max_residual"] < 1e-3
        xs0, ys0 = (a.numpy() for a in scaling.starts(problem, r["batch"]))
        jres = np.asarray(jrun_sweep(jp, _jax_option(), xs0, ys0, max_steps=MAX_STEPS)[3])
        np.testing.assert_allclose([r["median_residual"], r["max_residual"]],
                                   [np.median(jres), np.max(jres)], rtol=RTOL)

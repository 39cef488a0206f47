"""Batched multi-start sweep of the PyTorch port.

``batched_riptrm_solve`` at B = 3 on the golden ``Z`` (n = 50) with three
feasible starts made with numpy, float64, held to (i) the port's own
per-lane ``solve_compiled`` and (ii) the JAX ``batched_riptrm_solve`` lane
by lane.  Steps must be equal and final residuals within rtol 1e-6; the
tolerance 1e-5 stops every lane above the residual level (~1e-6) where the
reference's trajectory becomes sensitive to roundoff
(``test_torch_riptrm.py::test_run_tracks_jax_per_outer_iteration``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.parallel.sweep import batched_riptrm_solve as t_batched
from riptrm_torch.parallel.sweep import init_state_from
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers.riptrm import RIPTRM
from riptrm_tpu.parallel.sweep import batched_riptrm_solve as j_batched
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.utils.io import loadtxt

torch.set_num_threads(1)

OPT = {"maxiter": 30, "tolresid": 1e-5, "TRS_solver": "tCG",
       "second_order_stationarity": False}
MAX_STEPS = 200
B = 3


@pytest.fixture(scope="module")
def sweep():
    z = loadtxt("dataset/NonnegPCA/1/Z.csv")
    n = z.shape[0]
    rng = np.random.default_rng(3)
    xs = np.abs(rng.standard_normal((B, n))) + 0.01
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    ys = np.ones((B, n))
    tp = tn.make_problem(z, xs[0], device="cpu")
    state, steps, res = t_batched(tp, OPT, MAX_STEPS)(torch.tensor(xs), torch.tensor(ys))
    return z, xs, ys, tp, state, steps, res


def test_batched_matches_per_lane_solves(sweep):
    z, xs, ys, tp, state, steps, res = sweep
    assert steps.shape == (B,) and res.shape == (B,)
    solver = RIPTRM(OPT)
    solve = solver.solve_compiled(tp, MAX_STEPS)
    for i in range(B):
        st_i, k_i = solve(init_state_from(tp, solver.option, torch.tensor(xs[i:i + 1]),
                                          torch.tensor(ys[i:i + 1])))
        assert int(k_i[0]) == int(steps[i]), i
        np.testing.assert_allclose(state.x[i].numpy(), st_i.x[0].numpy(), rtol=1e-6,
                                   atol=1e-12)
    assert torch.all(res <= OPT["tolresid"])


def test_batched_matches_jax_sweep(sweep):
    z, xs, ys, _, state, steps, res = sweep
    jp = jn.make_problem(z, xs[0])
    j_state, j_steps, j_res = j_batched(jp, OPT, MAX_STEPS)(jnp.asarray(xs), jnp.asarray(ys))
    assert steps.tolist() == [int(v) for v in j_steps]
    np.testing.assert_allclose(res.numpy(), np.asarray(j_res), rtol=1e-6)
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(j_state.mu), rtol=1e-12)
    np.testing.assert_array_equal(state.outer_iter.numpy(), np.asarray(j_state.outer_iter))
    # lanes stop at different steps: the freeze is exercised
    assert len(set(steps.tolist())) > 1

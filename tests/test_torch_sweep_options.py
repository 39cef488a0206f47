"""The sweep options of the compiled solve loop, held to the JAX package.

``sweep_stall_window`` (a lane stops once its best residual has not
improved by 1 % in that many steps) and ``keep_best_point`` (each lane's
state at its best residual comes back in place of its final state), passed
by ``RIPTRM._solve_loop`` to ``base.compiled_best_while`` in both
packages.  The case: ``dataset/NonnegPCA/1`` with the three
``default_rng(3)`` starts of ``tests/test_torch_sweep.py``, float64,
``batched_riptrm_solve`` with maxiter 30, tolresid 1e-12 and 200 steps.
At tolresid 1e-12 no lane meets its tolerance, so without the options
every lane runs the whole budget.  Step counts must be equal, and
residuals within rtol 1e-6 where the reference's trajectory is not
sensitive to roundoff (see the keep_best_point test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.parallel.sweep import batched_riptrm_solve as t_batched
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers.riptrm import RIPTRM
from riptrm_tpu.parallel.sweep import batched_riptrm_solve as j_batched
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.utils.io import loadtxt

torch.set_num_threads(1)

OPT = {"maxiter": 30, "tolresid": 1e-12, "TRS_solver": "tCG",
       "second_order_stationarity": False}
MAX_STEPS = 200
B = 3


@pytest.fixture(scope="module")
def starts():
    z = loadtxt("dataset/NonnegPCA/1/Z.csv")
    n = z.shape[0]
    rng = np.random.default_rng(3)
    xs = np.abs(rng.standard_normal((B, n))) + 0.01
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    return z, xs, np.ones((B, n))


def _both(starts, extra, max_steps=MAX_STEPS):
    z, xs, ys = starts
    opt = OPT | extra
    tp = tn.make_problem(z, xs[0], device="cpu")
    t_state, t_steps, t_res = t_batched(tp, opt, max_steps)(torch.tensor(xs), torch.tensor(ys))
    jp = jn.make_problem(z, xs[0])
    j_state, j_steps, j_res = j_batched(jp, opt, max_steps)(jnp.asarray(xs), jnp.asarray(ys))
    return (t_state, t_steps.tolist(), t_res.numpy()), (j_state, [int(v) for v in j_steps],
                                                        np.asarray(j_res))


def test_stall_window_stops_lanes_as_jax_does(starts):
    (_, t_steps, t_res), (_, j_steps, j_res) = _both(starts, {"sweep_stall_window": 3})
    assert t_steps == j_steps
    assert max(t_steps) < MAX_STEPS  # the window, not the budget, stopped them
    np.testing.assert_allclose(t_res, j_res, rtol=1e-6)


def test_keep_best_point_returns_the_best_states_as_jax_does(starts):
    """Below a residual of ~1e-6 the reference's own trajectory moves
    under roundoff (ROADMAP.md queue 3): at 200 steps the two packages'
    final states lie at 7.4e-4, 2.6e-8, 1.0e-6 (JAX) and 8.7e-8, 1.8e-10,
    8.7e-8 (port).  So the best states are held to JAX lane by lane in two
    ways: with rtol 1e-6 at a 60-step budget, where every residual is
    still ~1.6e-5; and at 200 steps, both packages' best states lie at the
    floor below 1e-9 on every lane, and the port's are no worse than its
    own final states and better on some lane."""
    (t_state, t_steps, t_res), (j_state, j_steps, j_res) = _both(
        starts, {"keep_best_point": True})
    assert t_steps == j_steps == [MAX_STEPS] * B
    assert np.all(t_res <= 1e-9) and np.all(j_res <= 1e-9)
    z, xs, ys = starts
    final = t_batched(tn.make_problem(z, xs[0], device="cpu"), OPT, MAX_STEPS)(
        torch.tensor(xs), torch.tensor(ys))[2].numpy()
    assert np.all(t_res <= final) and np.any(t_res < final)
    (t_state, _, t_res), (j_state, _, j_res) = _both(starts, {"keep_best_point": True}, 60)
    np.testing.assert_allclose(t_res, j_res, rtol=1e-6)
    np.testing.assert_allclose(t_state.x.numpy(), np.asarray(j_state.x), rtol=1e-6, atol=1e-12)


def test_jax_option_name_is_refused():
    """The JAX package's ``use_pallas_tcg`` names the port's
    ``use_fused_tcg``; the port refuses it rather than ignore it."""
    with pytest.raises(NotImplementedError, match="use_fused_tcg"):
        RIPTRM(OPT | {"use_pallas_tcg": True}).solve_compiled(
            tn.make_problem(np.eye(4), np.full(4, 0.5), device="cpu"), 1)

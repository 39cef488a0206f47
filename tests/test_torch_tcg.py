"""``truncated_cg`` of the PyTorch port against ``riptrm_tpu.ops.tcg``.

The n = 64 fixture of ``tests/test_pallas.py`` (spiked Z and a start from
the JAX generators), turned into numpy arrays and handed to both packages
at float64.  The Hessian is each package's own AD barrier operator.
Iteration counts and stop codes must be equal; eta to atol 1e-10 (CG at
float64 on a barrier operator of moderate conditioning).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops.tcg import truncated_cg as t_tcg
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import riptrm as t_riptrm
from riptrm_tpu.ops.tcg import truncated_cg as j_tcg
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import riptrm as j_riptrm

torch.set_num_threads(1)

ATOL = 1e-10


@pytest.fixture(scope="module")
def fixture():
    n = 64
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    z = np.asarray(jn.generate_instance(k1, n)["Z"], np.float64)
    x0 = np.abs(np.asarray(jax.random.normal(k2, (n,)), np.float64))
    x0 /= np.linalg.norm(x0)
    return jn.make_problem(z, x0), tn.make_problem(z, x0, device="cpu")


def _jax_tcg(jp, x, y, mu, radius):
    _, hw, cx = j_riptrm._barrier_ops(jp, x, y, mu)
    dim = jp.manifold.dim
    f = jax.jit(lambda cx, r: j_tcg(jp.manifold, x, hw, cx, r, maxinner=dim))
    eta, heta, it, code = f(cx, radius)
    return np.asarray(eta), np.asarray(heta), int(it), int(code)


def test_tcg_one_lane_matches_jax(fixture):
    jp, tp = fixture
    x, y = np.asarray(jp.x0), np.ones(jp.num_ineq)
    mu, radius = 0.1, np.pi / 8
    eta_j, heta_j, it_j, code_j = _jax_tcg(jp, jnp.asarray(x), jnp.asarray(y), mu, radius)

    xt, yt = torch.as_tensor(x)[None], torch.as_tensor(y)[None]
    _, hw, cx = t_riptrm._barrier_ops(tp, xt, yt, torch.full((1,), mu, dtype=torch.float64))
    eta, heta, it, code = t_tcg(tp.manifold, xt, hw, cx, torch.full((1,), radius,
                                dtype=torch.float64), maxinner=tp.manifold.dim)
    assert int(it[0]) == it_j
    assert int(code[0]) == code_j
    np.testing.assert_allclose(eta[0].numpy(), eta_j, atol=ATOL)
    np.testing.assert_allclose(heta[0].numpy(), heta_j, atol=ATOL)


def test_tcg_lanes_mixed_radii_match_jax(fixture):
    """B = 4 lanes with mixed radii (``test_pallas.py::test_batched_tcg_interpret``),
    one lane-batched call against four JAX calls."""
    jp, tp = fixture
    n, b = jp.manifold.n, 4
    xs = np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(6), (b, n)), np.float64))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    ys = 0.5 + np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(7), (b, n)), np.float64))
    radii = np.array([0.1, 0.3, 0.5, 0.2])
    mu = 0.05

    xt, yt = torch.as_tensor(xs), torch.as_tensor(ys)
    _, hw, cx = t_riptrm._barrier_ops(tp, xt, yt, torch.full((b,), mu, dtype=torch.float64))
    etas, _, iters, codes = t_tcg(tp.manifold, xt, hw, cx, torch.as_tensor(radii),
                                  maxinner=tp.manifold.dim)
    for i in range(b):
        eta_j, _, it_j, code_j = _jax_tcg(
            jp, jnp.asarray(xs[i]), jnp.asarray(ys[i]), mu, radii[i]
        )
        assert int(iters[i]) == it_j, i
        assert int(codes[i]) == code_j, i
        np.testing.assert_allclose(etas[i].numpy(), eta_j, atol=ATOL, err_msg=str(i))
    # the lanes stop at different iterations: the done mask is exercised
    assert len(set(iters.tolist())) > 1


def test_tcg_max_inner_iter_stop(fixture):
    """A budget of 2 inner iterations stops with code 0 on both sides."""
    jp, tp = fixture
    x, y = np.asarray(jp.x0), np.ones(jp.num_ineq)
    _, hw_j, cx_j = j_riptrm._barrier_ops(jp, jnp.asarray(x), jnp.asarray(y), 0.1)
    eta_j, _, it_j, code_j = j_tcg(jp.manifold, jnp.asarray(x), hw_j, cx_j, 10.0,
                                   maxinner=2, kappa=1e-8)
    xt, yt = torch.as_tensor(x)[None], torch.as_tensor(y)[None]
    _, hw, cx = t_riptrm._barrier_ops(tp, xt, yt, torch.full((1,), 0.1, dtype=torch.float64))
    eta, _, it, code = t_tcg(tp.manifold, xt, hw, cx, 10.0, maxinner=2, kappa=1e-8)
    assert (int(it[0]), int(code[0])) == (int(it_j), int(code_j)) == (2, 0)
    np.testing.assert_allclose(eta[0].numpy(), np.asarray(eta_j), atol=ATOL)

"""Problem layer of the PyTorch port against ``riptrm_tpu`` on the golden
NonnegPCA instance (``dataset/NonnegPCA/1``, point a, n = 50).

Both packages load the same CSV files; the port evaluates two lanes at
once (point a and a second feasible point) and each lane is held to the
JAX problem at that point.  float64, rtol 1e-10 (plus an atol of 1e-13
for entries that are zero up to roundoff).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops.kkt import evaluation as t_evaluation
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_tpu.ops.kkt import evaluation as j_evaluation
from riptrm_tpu.problems import nonneg_pca as jn

torch.set_num_threads(1)

DATA = "dataset/NonnegPCA/1"
RTOL, ATOL = 1e-10, 1e-13


@pytest.fixture(scope="module")
def both():
    jp = jn.load_problem(DATA, "a")
    tp = tn.load_problem(DATA, "a", device="cpu")
    n = int(jp.x0.shape[0])
    rng = np.random.default_rng(0)
    x1 = np.abs(rng.standard_normal(n)) + 0.05
    x1 /= np.linalg.norm(x1)
    xs = np.stack([np.asarray(jp.x0), x1])
    ys = np.stack([np.asarray(jp.y0), 0.5 + rng.random(n)])
    vs = rng.standard_normal((2, n))
    vs -= np.sum(vs * xs, 1, keepdims=True) * xs  # tangent at x
    ws = rng.standard_normal((2, n))
    return jp, tp, xs, ys, vs, ws


def _t(a):
    return torch.as_tensor(a)


CASES = {
    "cost": (lambda p, x, y, v, w: p.cost(x), lambda p, x, y, v, w: p.cost(x)),
    "egrad": (lambda p, x, y, v, w: p.egrad(x), lambda p, x, y, v, w: p.egrad(x)),
    "rgrad": (lambda p, x, y, v, w: p.rgrad(x), lambda p, x, y, v, w: p.rgrad(x)),
    "slack": (lambda p, x, y, v, w: p.slack(x), lambda p, x, y, v, w: p.slack(x)),
    "ineq_val": (lambda p, x, y, v, w: p.ineq_val(x), lambda p, x, y, v, w: p.ineq_val(x)),
    "eq_val": (lambda p, x, y, v, w: p.eq_val(x), lambda p, x, y, v, w: p.eq_val(x)),
    "manvio": (lambda p, x, y, v, w: p.manvio(x), lambda p, x, y, v, w: p.manvio(x)),
    "lag_rgrad": (
        lambda p, x, y, v, w: p.lag_rgrad(x, y),
        lambda p, x, y, v, w: p.lag_rgrad(x, y),
    ),
    "lag_rhess_at": (
        lambda p, x, y, v, w: p.lag_rhess_at(x, y)(v),
        lambda p, x, y, v, w: p.lag_rhess_at(x, y)(v),
    ),
    "gx_at": (lambda p, x, y, v, w: p.gx_at(x)(w), lambda p, x, y, v, w: p.gx_at(x)(w)),
    "gx_adj_at": (
        lambda p, x, y, v, w: p.gx_adj_at(x)(v),
        lambda p, x, y, v, w: p.gx_adj_at(x)(v),
    ),
    "gx_adj": (
        lambda p, x, y, v, w: p.gx_adj(x, v),
        lambda p, x, y, v, w: p.gx_adj(x, v),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax(both, name):
    jp, tp, xs, ys, vs, ws = both
    t_fn, j_fn = CASES[name]
    got = t_fn(tp, *map(_t, (xs, ys, vs, ws))).numpy()
    for i in range(2):
        want = np.asarray(j_fn(jp, *(jnp.asarray(a[i]) for a in (xs, ys, vs, ws))))
        np.testing.assert_allclose(got[i], want, rtol=RTOL, atol=ATOL)


def test_evaluation_matches_jax(both):
    jp, tp, xs, ys, _, _ = both
    x_prev = np.stack([xs[1], xs[0]])
    got = t_evaluation(tp, _t(x_prev), _t(xs), _t(ys))
    for i in range(2):
        want = j_evaluation(
            jp, jnp.asarray(x_prev[i]), jnp.asarray(xs[i]), jnp.asarray(ys[i]),
            jnp.zeros((0,)),
        )
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(
                got[k][i].item(), float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k
            )


def test_problem_data_and_structure(both):
    jp, tp, *_ = both
    assert tp.num_ineq == jp.num_ineq and tp.num_eq == jp.num_eq
    assert tp.structure["kind"] == jp.structure["kind"] == "sphere_quadratic"
    np.testing.assert_array_equal(tp.structure["Zs"].numpy(), np.asarray(jp.structure["Zs"]))
    np.testing.assert_array_equal(tp.x0.numpy(), np.asarray(jp.x0))
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))


def test_generators_follow_the_jax_distribution():
    """Same construction as the JAX generators (the draws differ): a
    symmetric-spike-plus-noise Z and unit, nonnegative initial points."""
    g = torch.Generator().manual_seed(0)
    n = 40
    z = tn.generate_instance(g, n, device="cpu")["Z"]
    assert z.shape == (n, n) and z.dtype == torch.float64
    spike = z - z.T  # the spike is symmetric: only noise survives
    assert torch.all(torch.diagonal(spike) == 0)
    x0 = tn.generate_initialpoint(g, n, device="cpu")
    assert abs(torch.linalg.vector_norm(x0).item() - 1.0) < 1e-12
    assert torch.all(x0 >= 0)

"""The compensated reductions of the PyTorch port (``ops/compensated.py``)
against ``riptrm_tpu``'s, and RIPTRM with ``compensated_reductions``.

The cases of ``tests/test_compensated.py``, in float32 as there (the
module exists for the float32 lane floor), each held to the same float64
ground truth with the same bound and to the JAX function on the same
inputs: the error-free transforms bit for bit (TwoSum, TwoProd with the
float32 and float64 splitters: both packages do the same IEEE operations
in the same order), the reductions to 2 float32 ulps of the JAX value
(the compensated tree may pair its terms alike but XLA may fuse the
level sums in another order).  Then one RIPTRM run with
``compensated_reductions=True`` on ``dataset/NonnegPCA/1`` point a in
float64 against the JAX run with the same option: the same outer
iterations, and the residual at each to rtol 1e-6 while it is above 1e-6
(as the golden tCG test, ``tests/test_torch_riptrm.py``: within an outer
iteration the tCG's accept/reject decisions follow the rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops import compensated as tc
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.ops import compensated as jc
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import riptrm as jrm

torch.set_num_threads(1)

F32_ULP = np.finfo(np.float32).eps


def _pair(x, dtype=np.float32):
    x = np.asarray(x, dtype)
    return torch.tensor(x), jnp.asarray(x)


def _near_jax(t, j, ulps=2):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    np.testing.assert_allclose(t, j, rtol=ulps * F32_ULP, atol=0)


def test_two_sum_exact_and_equal():
    rng = np.random.default_rng(0)
    (ta, ja), (tb, jb) = (_pair(rng.normal(size=256) * 10.0 ** rng.integers(-6, 6, 256))
                          for _ in range(2))
    s, e = tc.two_sum(ta, tb)
    exact = ta.double().numpy() + tb.double().numpy()
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(), exact)
    js_, je = jc.two_sum(ja, jb)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_two_prod_exact_and_equal(dtype):
    rng = np.random.default_rng(1 if dtype == np.float32 else 2)
    (ta, ja), (tb, jb) = (_pair(rng.normal(size=256), dtype) for _ in range(2))
    p, e = tc.two_prod(ta, tb)
    if dtype == np.float32:
        exact = ta.double().numpy() * tb.double().numpy()
        np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(), exact)
    else:
        err = p.numpy() - (ta.numpy() * tb.numpy() - e.numpy())
        assert np.max(np.abs(err)) == 0.0
    jp_, je = jc.two_prod(ja, jb)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp_))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_sum2_illconditioned():
    rng = np.random.default_rng(3)
    big = rng.normal(size=2048).astype(np.float32) * 1e6
    tail = rng.normal(size=2048).astype(np.float32) * 1e-4
    x = np.concatenate([big, -big, tail]).astype(np.float32)
    rng.shuffle(x)
    exact = float(np.sum(np.asarray(x, np.float64)))
    tx, jx = _pair(x)
    got = float(tc.sum2(tx))
    assert abs(got - exact) <= 1e-3 * abs(exact)
    assert abs(float(torch.sum(tx)) - exact) > 1e3 * abs(got - exact)
    _near_jax(got, jc.sum2(jx))


def test_sum2_odd_length_and_axis():
    rng = np.random.default_rng(4)
    tx, jx = _pair(rng.normal(size=(5, 777)))
    x64 = tx.double().numpy()
    np.testing.assert_allclose(tc.sum2(tx, dim=-1).numpy(), x64.sum(-1), rtol=1e-6)
    np.testing.assert_allclose(tc.sum2(tx, dim=0).numpy(), x64.sum(0), rtol=1e-6)
    _near_jax(tc.sum2(tx, dim=-1).numpy(), jc.sum2(jx, axis=-1))
    _near_jax(tc.sum2(tx, dim=0).numpy(), jc.sum2(jx, axis=0))


def test_sum2_lanes():
    """Over the last axis of [B, m], lane by lane (the JAX vmap case)."""
    rng = np.random.default_rng(5)
    tx, jx = _pair(rng.normal(size=(8, 1000)))
    np.testing.assert_allclose(tc.sum2(tx).numpy(), tx.double().numpy().sum(-1), rtol=1e-6)
    _near_jax(tc.sum2(tx).numpy(), jc.sum2(jx))


def test_complementarity_norm_subfloor():
    rng = np.random.default_rng(6)
    m = 4096
    mu = np.float32(1e-2)
    c = rng.uniform(0.5, 2.0, m).astype(np.float32)
    delta = (rng.normal(size=m) * 1e-3).astype(np.float32)
    y = (np.float64(mu) * (1.0 + np.asarray(delta, np.float64))
         / np.asarray(c, np.float64)).astype(np.float32)
    exact = float(np.linalg.norm(np.asarray(y, np.float64) * np.asarray(c, np.float64)
                                 - np.float64(mu)))
    (ty, jy), (tcc, jcc) = _pair(y), _pair(c)
    got = float(tc.complementarity_norm(ty, tcc, mu))
    naive = float(torch.linalg.vector_norm(ty * tcc - mu))
    assert abs(got - exact) <= 1e-5 * exact
    assert abs(naive - exact) >= abs(got - exact)
    _near_jax(got, jc.complementarity_norm(jy, jcc, mu))


def test_complementarity_norm_deep_floor_and_lanes():
    """delta = 0 exactly: the compensated norm adds no noise of its own;
    and with a per-lane mu [B] over [B, m] it equals each lane alone."""
    rng = np.random.default_rng(7)
    m = 4096
    mu = np.float32(3e-3)
    c = rng.uniform(0.5, 2.0, m).astype(np.float32)
    y = (np.float32(mu) / c).astype(np.float32)
    exact = float(np.linalg.norm(np.asarray(y, np.float64) * np.asarray(c, np.float64)
                                 - np.float64(mu)))
    (ty, jy), (tcc, jcc) = _pair(y), _pair(c)
    got = float(tc.complementarity_norm(ty, tcc, mu))
    assert abs(got - exact) <= 1e-6 * exact
    _near_jax(got, jc.complementarity_norm(jy, jcc, mu))
    lanes = tc.complementarity_norm(torch.stack([ty, 2 * ty]), torch.stack([tcc, tcc]),
                                    torch.tensor([mu, 2 * mu]))
    assert float(lanes[0]) == got
    assert float(lanes[1]) == float(tc.complementarity_norm(2 * ty, tcc, 2 * mu))


def test_barrier_log_ratio_sum_tiny_moves():
    rng = np.random.default_rng(8)
    m = 4096
    mu = np.float32(1e-3)
    c = rng.uniform(0.5, 2.0, m).astype(np.float32)
    c_new = c * (1.0 + rng.normal(size=m).astype(np.float32) * 1e-5)
    exact = float(np.float64(mu) * np.sum(np.log(np.asarray(c_new, np.float64)
                                                 / np.asarray(c, np.float64))))
    (tn_, jn_), (tcc, jcc) = _pair(c_new), _pair(c)
    got = float(tc.barrier_log_ratio_sum(tn_, tcc, mu))
    naive = float(mu * torch.sum(torch.log(tn_ / tcc)))
    assert abs(got - exact) <= 1e-4 * abs(exact) + 1e-10
    assert abs(naive - exact) >= abs(got - exact)
    _near_jax(got, jc.barrier_log_ratio_sum(jn_, jcc, mu))


@pytest.mark.parametrize("c,c_new,want", [
    ([1.0, -0.5, 2.0, 0.0], [2.0, 1.0, -1.0, 3.0], np.log(2.0)),  # masking
    ([1.0, 1.0], [0.25, 8.0], np.log(0.25) + np.log(8.0)),  # ratios outside [1/2, 2]
])
def test_barrier_log_ratio_sum_branches(c, c_new, want):
    (tcc, jcc), (tn_, jn_) = _pair(c), _pair(c_new)
    got = float(tc.barrier_log_ratio_sum(tn_, tcc, np.float32(1.0)))
    assert got == pytest.approx(want, rel=1e-6)
    _near_jax(got, jc.barrier_log_ratio_sum(jn_, jcc, np.float32(1.0)))


def test_riptrm_compensated_run_against_jax():
    opt = {"maxtime": 120, "maxiter": 30, "tolresid": 1e-8, "TRS_solver": "tCG",
           "second_order_stationarity": False, "compensated_reductions": True}
    j_out = jrm.RIPTRM(opt).run(jn.load_problem("dataset/NonnegPCA/1", "a"))
    t_out = trm.RIPTRM(opt).run(tn.load_problem("dataset/NonnegPCA/1", "a", device="cpu"))
    assert t_out.log["residual"][-1] <= 1e-8
    assert t_out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)
    def outer_rows(log):
        return [(it, r) for it, s, r in zip(log["iteration"], log["inner_status"],
                                            log["residual"]) if s == "converged"]

    j_rows, t_rows = outer_rows(j_out.log), outer_rows(t_out.log)
    assert [it for it, _ in t_rows] == [it for it, _ in j_rows]
    for (_, a), (_, b) in zip(t_rows, j_rows):
        if b > 1e-6:
            np.testing.assert_allclose(a, b, rtol=1e-6)

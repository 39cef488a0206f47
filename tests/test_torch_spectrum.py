"""Matrix-free Lanczos of the PyTorch port against
``riptrm_tpu/ops/spectrum.py::lanczos`` (the cases of
``tests/test_spectrum.py``), float64 on the CPU.

* extreme eigenvalues of the golden NonnegPCA Hessian (n = 50) from a
  seeded tangent start: the JAX function's alphas, betas and Ritz values
  (atol 1e-10) and the dense spectrum's extremes (atol 1e-8);
* the Krylov breakdown case: no spurious zero Ritz value;
* lanes are independent: a lane's result does not depend on the others;
* ``certify_second_order`` (``tests/test_parallel.py``'s certificate
  tests, N = 16, B = 8) on the port's sweep's final points, and on the JAX
  sweep's final points against the JAX function: rtol 1e-9 uncapped, rtol
  1e-6 with ``ratio_cap=1e8`` (an operator of norm ~1e8 in float64), and
  NaN exactly on infeasible lanes.

The non-flat-metric case (SPD) waits for the SPD manifold (ROADMAP.md
queue 1 item 5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from riptrm_torch.ops import spectrum as tspec
from riptrm_torch.parallel import sweep as tsw
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_tpu.ops import spectrum as jspec
from riptrm_tpu.parallel import sweep as jsw
from riptrm_tpu.problems import nonneg_pca as jn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    tp = tn.load_problem("dataset/NonnegPCA/1", "a", device="cpu")
    jp = jn.load_problem("dataset/NonnegPCA/1", "a")
    rng = np.random.default_rng(1)
    x = tp.x0[None]
    starts = tp.manifold.proj(x, torch.tensor(rng.standard_normal((2, tp.manifold.n))))
    return tp, jp, x.expand(2, -1).clone(), starts


@pytest.mark.parametrize("k", [10, 40])
def test_lanczos_matches_jax(golden, k):
    tp, jp, x, v0 = golden
    alphas, betas, ritz = tspec.lanczos(lambda v: tp.rhess(x, v), v0,
                                        lambda u, t: tp.manifold.inner(x, u, t), k)
    assert alphas.shape == (2, k) and betas.shape == (2, k - 1) and ritz.shape == (2, k)
    for i in range(2):
        ja, jbeta, jr = jspec.lanczos(lambda v: jp.rhess(jp.x0, v), jnp.asarray(v0[i].numpy()),
                                      lambda u, t: jp.manifold.inner(jp.x0, u, t), k)
        np.testing.assert_allclose(alphas[i].numpy(), np.asarray(ja), atol=1e-10)
        np.testing.assert_allclose(betas[i].numpy(), np.asarray(jbeta), atol=1e-10)
        np.testing.assert_allclose(ritz[i].numpy(), np.asarray(jr), atol=1e-10)
    if k == 40:
        w, _ = tspec.hessian_spectrum(tp, x[:1], descending_abs=False)
        assert abs(float(ritz[0, 0]) - float(w[0, 0])) < 1e-8
        assert abs(float(ritz[0, -1]) - float(w[0, -1])) < 1e-8
    # one lane alone gives the same values as in the batch
    _, _, r1 = tspec.lanczos(lambda v: tp.rhess(x[1:], v), v0[1:],
                             lambda u, t: tp.manifold.inner(x[1:], u, t), k)
    np.testing.assert_allclose(r1[0].numpy(), ritz[1].numpy(), atol=1e-12)


def test_lanczos_breakdown_no_spurious_zeros():
    """v0 spans a 2-dimensional invariant subspace of diag(3, 5, ..., 13):
    the Ritz extremes are 3 and 5 (atol 1e-9), as JAX's, and no zero
    appears; the second lane (a full Krylov space) is unaffected."""
    d = torch.tensor([3.0, 5.0, 7.0, 9.0, 11.0, 13.0], dtype=torch.float64)
    v0 = torch.zeros((2, 6), dtype=torch.float64)
    v0[0, :2] = 1.0
    v0[1] = torch.linspace(1.0, 2.0, 6, dtype=torch.float64)
    _, _, ritz = tspec.lanczos(lambda v: d * v, v0, lambda u, t: torch.sum(u * t, -1), 6)
    _, _, jr = jspec.lanczos(lambda v: jnp.asarray(d.numpy()) * v, jnp.asarray(v0[0].numpy()),
                             lambda u, t: jnp.vdot(u, t), 6)
    assert abs(float(ritz[0, 0]) - 3.0) < 1e-9 and abs(float(ritz[0, -1]) - 5.0) < 1e-9
    assert float(ritz[0, 0]) > 2.9
    np.testing.assert_allclose(ritz[0].numpy(), np.asarray(jr), atol=1e-9)
    np.testing.assert_allclose(ritz[1, [0, -1]].numpy(), [3.0, 13.0], atol=1e-9)


def test_lanczos_nonfinite_lane_gives_nan():
    """A lane whose operator returns NaN yields NaN Ritz values (the JAX
    function's), where torch's eigvalsh would raise; the other lane is
    unaffected."""
    d = torch.tensor([[1.0, 2.0, 3.0], [float("nan"), 2.0, 3.0]], dtype=torch.float64)
    v0 = torch.ones((2, 3), dtype=torch.float64)
    _, _, ritz = tspec.lanczos(lambda v: d * v, v0, lambda u, t: torch.sum(u * t, -1), 3)
    assert torch.isnan(ritz[1]).all()
    np.testing.assert_allclose(ritz[0].numpy(), [1.0, 2.0, 3.0], atol=1e-12)


# ---------------------------------------------------------------------------
# certify_second_order
# ---------------------------------------------------------------------------
N, BATCH = 16, 8
SWEEP = {"maxiter": 12, "tolresid": 1e-7, "TRS_solver": "tCG",
         "second_order_stationarity": False}


@pytest.fixture(scope="module")
def sweep_setup():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    z = np.asarray(jn.generate_instance(k1, N)["Z"])
    xs = np.abs(np.asarray(jax.random.normal(k2, (BATCH, N))))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    return (jn.make_problem(z, xs[0]), tn.make_problem(z, xs[0], device="cpu"), xs,
            np.ones((BATCH, N)))


def _final_points(setup, option):
    jp, tp, xs, ys = setup
    t_st, _, t_res = tsw.batched_riptrm_solve(tp, option, 400)(torch.tensor(xs),
                                                               torch.tensor(ys))
    j_st, _, _ = jsw.batched_riptrm_solve(jp, option, 400)(jnp.asarray(xs), jnp.asarray(ys))
    return t_st, t_res, np.asarray(j_st.x), np.asarray(j_st.y)


@pytest.mark.parametrize("ratio_cap", [None, 1e8], ids=["uncapped", "capped"])
def test_certify_second_order_matches_jax(sweep_setup, ratio_cap):
    """Uncapped after a sweep to 1e-7 (test_certify_second_order_batch);
    capped at 1e8 after a deep one to 1e-12
    (test_certify_second_order_ratio_cap), where the uncapped certificate
    is rounding of the barrier weights' scale."""
    jp, tp = sweep_setup[:2]
    deep = ratio_cap is not None
    option = SWEEP | ({"maxiter": 40, "tolresid": 1e-12} if deep else {})
    t_st, t_res, jx, jy = _final_points(sweep_setup, option)
    assert float(t_res.max()) < (1e-10 if deep else 1e-3)
    got = tsw.certify_second_order(tp, t_st.x, t_st.y, ratio_cap=ratio_cap)
    assert got.shape == (BATCH,)
    # the maximisation's interior-point solutions are strict local minima
    # of the barrier problem: Hw bounded below
    assert torch.all(got > (-1e-6 if deep else -1e-5))
    if deep:
        assert torch.all(torch.abs(got) < 1e3)
    on_jax = tsw.certify_second_order(tp, torch.tensor(jx), torch.tensor(jy),
                                      ratio_cap=ratio_cap)
    want = np.asarray(jsw.certify_second_order(jp, jnp.asarray(jx), jnp.asarray(jy),
                                               ratio_cap=ratio_cap))
    np.testing.assert_allclose(on_jax.numpy(), want, rtol=1e-6 if deep else 1e-9)


def test_certify_ratio_cap_flags_infeasible_lanes(sweep_setup):
    """A lane with min(slack) <= 0 comes back NaN, the others finite, as in
    JAX (rtol 1e-6 on the finite ones)."""
    jp, tp, xs, ys = sweep_setup
    bad = xs.copy()
    bad[0, 0] = -abs(bad[0, 0]) - 0.1
    bad /= np.linalg.norm(bad, axis=1, keepdims=True)
    got = tsw.certify_second_order(tp, torch.tensor(bad), torch.tensor(ys), ratio_cap=1e8)
    want = np.asarray(jsw.certify_second_order(jp, jnp.asarray(bad), jnp.asarray(ys),
                                               ratio_cap=1e8))
    assert torch.isnan(got[0]) and torch.all(torch.isfinite(got[1:]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("fn", ["eigh_nan", "eigvalsh_nan"])
def test_eigh_in_slices_equals_one_batch(fn, monkeypatch):
    """Above ``EIGH_BATCH`` matrices the eigendecomposition runs in slices
    (cuSOLVER's batched syev refuses 131072 at once): the slices give the
    one batch's result bit for bit, NaN lanes included, over any leading
    shape."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 7, 5, 5))
    a = torch.tensor(a + a.swapaxes(-1, -2))
    a[1, 2, 0, 0] = float("nan")
    whole = getattr(tspec, fn)(a)
    monkeypatch.setattr(tspec, "EIGH_BATCH", 4)
    sliced = getattr(tspec, fn)(a)
    for w, s in zip(*((t,) if fn == "eigvalsh_nan" else t for t in (whole, sliced))):
        assert s.shape == w.shape and torch.equal(torch.isnan(s), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(s), torch.nan_to_num(w))
    assert torch.isnan(sliced[0] if fn == "eigh_nan" else sliced)[1, 2].all()

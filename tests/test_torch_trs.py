"""Exact TRS solvers of the PyTorch port against ``riptrm_tpu/ops/trs.py``.

``solve_trs`` / ``solve_trs_eig`` and ``solve_trs_ms`` on the cases of
``tests/test_ops.py`` (interior, boundary, indefinite and hard case, and
TestTRSMoreSorensen's random, interior, hard-case and float32 cases), made
from the same seeded numpy draws.  The port solves every case of a kind as
one lane-batched call (lanes of one size); each lane is held to the JAX
function's solution of that case alone: float64, atol 1e-9 on p and lam,
equal codes, and in the hard case (where solutions are not unique) the
model value to rtol 1e-8 and the radius to rtol 1e-8.  The float32 case
holds the model value to 1e-5 relative, as the JAX test does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops import trs as tt
from riptrm_tpu.ops import trs as jt

torch.set_num_threads(1)


def _orth(rng, n):
    return np.linalg.qr(rng.normal(size=(n, n)))[0]


def _cases(kind):
    """[(A, a, radius)] of one size, from ``tests/test_ops.py``'s draws."""
    if kind == "interior":
        rng = np.random.default_rng(0)
        q = _orth(rng, 8)
        return [(q @ np.diag(rng.uniform(1, 5, 8)) @ q.T, rng.normal(size=8) * 0.01, 10.0)]
    if kind == "boundary":
        rng = np.random.default_rng(1)
        q = _orth(rng, 8)
        return [(q @ np.diag(rng.uniform(1, 5, 8)) @ q.T, rng.normal(size=8) * 10, 0.5)]
    if kind == "indefinite":
        rng = np.random.default_rng(2)
        q = _orth(rng, 6)
        a_mat = q @ np.diag([-2.0, -1.0, 0.5, 1.0, 2.0, 3.0]) @ q.T
        return [(a_mat, rng.normal(size=6), 1.0)]
    if kind == "hard":
        return [(np.diag([-2.0, 1.0, 2.0, 3.0]), np.array([0.0, 0.1, 0.1, 0.1]), 5.0)]
    if kind == "random":
        rng = np.random.default_rng(0)
        out = []
        for trial in range(12):
            b = rng.normal(size=(50, 50))
            a_mat = (b + b.T) / 2
            if trial % 3 == 1:
                a_mat = a_mat @ a_mat.T / 50 + np.eye(50)
            a = rng.normal(size=50) * (10.0 ** rng.integers(-2, 2))
            out.append((a_mat, a, float(10.0 ** rng.integers(-1, 2))))
        return out
    if kind == "hard_geometry":
        rng = np.random.default_rng(2)
        b = rng.normal(size=(40, 40))
        a_mat = (b + b.T) / 2
        _, q = np.linalg.eigh(a_mat)
        a = rng.normal(size=40)
        return [(a_mat, (a - q[:, 0] * (q[:, 0] @ a)) * 1e-3, 1.0)]
    raise ValueError(kind)


def _batch(cases, dtype=torch.float64):
    a_mat, a, r = (np.stack([c[i] for c in cases]) for i in range(3))
    return (torch.tensor(a_mat, dtype=dtype), torch.tensor(a, dtype=dtype),
            torch.tensor(r, dtype=dtype))


def _model(a_mat, a, p):
    return 0.5 * p @ a_mat @ p + a @ p


@pytest.mark.parametrize("kind", ["interior", "boundary", "indefinite", "hard", "random"])
def test_solve_trs_eig_matches_jax(kind):
    cases = _cases(kind)
    t_a, t_g, t_r = _batch(cases)
    lam, q = torch.linalg.eigh(t_a)
    p, lam_out, code, p_c = tt.solve_trs_eig(lam, q, t_g, t_r)
    p2, _, _ = tt.solve_trs(t_a, t_g, t_r)
    np.testing.assert_allclose(p2.numpy(), p.numpy(), atol=1e-12)
    np.testing.assert_allclose(torch.einsum("bij,bj->bi", q, p_c).numpy(), p.numpy(),
                               atol=1e-12)
    for i, (a_mat, a, r) in enumerate(cases):
        jp, jl, jc = jt.solve_trs(jnp.asarray(a_mat), jnp.asarray(a), r)
        assert int(code[i]) == int(jc), i
        np.testing.assert_allclose(float(lam_out[i]), float(jl), atol=1e-9)
        if int(jc) == 2:  # the hard case's solution is not unique
            np.testing.assert_allclose(_model(a_mat, a, p[i].numpy()),
                                       _model(a_mat, a, np.asarray(jp)), rtol=1e-8)
            np.testing.assert_allclose(np.linalg.norm(p[i].numpy()), r, rtol=1e-8)
        else:
            np.testing.assert_allclose(p[i].numpy(), np.asarray(jp), atol=1e-9)
    if kind == "hard":
        assert int(code[0]) == 2 and float(lam_out[0]) == pytest.approx(2.0, abs=1e-8)


@pytest.mark.parametrize("kind", ["interior", "boundary", "indefinite", "hard", "random",
                                  "hard_geometry"])
def test_solve_trs_ms_matches_jax(kind):
    """Moré-Sorensen, lanes batched, against the JAX function per case: the
    same code, p and lam to atol 1e-9 (boundary and interior), the Lanczos
    lambda_min estimate to atol 1e-9, and in the hard case the model value
    (rtol 1e-8) on the boundary (rtol 1e-4, the JAX test's)."""
    cases = _cases(kind)
    p, lam_out, code, mineig = tt.solve_trs_ms(*_batch(cases))
    for i, (a_mat, a, r) in enumerate(cases):
        jp, jl, jc, jme = jt.solve_trs_ms(jnp.asarray(a_mat), jnp.asarray(a), r)
        assert int(code[i]) == int(jc), i
        np.testing.assert_allclose(float(mineig[i]), float(jme), atol=1e-9)
        if int(jc) == 2:
            np.testing.assert_allclose(_model(a_mat, a, p[i].numpy()),
                                       _model(a_mat, a, np.asarray(jp)), rtol=1e-8)
            assert abs(np.linalg.norm(p[i].numpy()) - r) <= 1e-4 * r
        else:
            np.testing.assert_allclose(p[i].numpy(), np.asarray(jp), atol=1e-9)
            np.testing.assert_allclose(float(lam_out[i]), float(jl), atol=1e-9)


def test_solve_trs_ms_lam_est_and_float32():
    """With the caller's lambda extremes (RIPTRM's ms cache) the solution is
    JAX's given the same extremes (atol 1e-9); in float32 the model value is
    within 1e-5 of the float64 optimum (tests/test_ops.py::test_f32)."""
    cases = _cases("random")[:6]
    t_a, t_g, t_r = _batch(cases)
    ev = torch.linalg.eigvalsh(t_a)
    p, _, code, _ = tt.solve_trs_ms(t_a, t_g, t_r, lam_est=(ev[:, 0], ev[:, -1]))
    for i, (a_mat, a, r) in enumerate(cases):
        jp, _, jc, _ = jt.solve_trs_ms(jnp.asarray(a_mat), jnp.asarray(a), r,
                                       lam_est=(float(ev[i, 0]), float(ev[i, -1])))
        assert int(code[i]) == int(jc)
        np.testing.assert_allclose(p[i].numpy(), np.asarray(jp), atol=1e-9)

    rng = np.random.default_rng(4)
    b = rng.normal(size=(80, 80)).astype(np.float32)
    a32 = ((b + b.T) / 2)[None]
    g32 = rng.normal(size=80).astype(np.float32)[None]
    p32, _, _, _ = tt.solve_trs_ms(torch.tensor(a32), torch.tensor(g32),
                                   torch.tensor([1.0], dtype=torch.float32))
    a64, g64 = a32[0].astype(np.float64), g32[0].astype(np.float64)
    p64, _, _ = jt.solve_trs(jnp.asarray(a64), jnp.asarray(g64), 1.0)
    m1 = _model(a64, g64, np.asarray(p64))
    m2 = _model(a64, g64, p32[0].numpy().astype(np.float64))
    assert m2 <= m1 + 1e-5 * abs(m1)

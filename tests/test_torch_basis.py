"""Tangent bases and operator materialisation of the PyTorch port against
``riptrm_tpu`` (``manifolds/*.basis``, ``ops/basis.py``,
``Problem.rhess``/``lag_rhess``, ``ops/spectrum.py::operator_spectrum``).

The same seeded numpy inputs go through both packages, float64 on the CPU,
lane by lane (the port carries a leading lane axis).  The sphere's
Householder basis is deterministic, so it and every coordinate in it are
held to JAX's to atol 1e-12.  Stiefel's basis rests on a complete QR whose
column signs LAPACK may choose otherwise than JAX, so there the tests
compare what does not depend on them: orthonormality, round trips, spectra
and ambient vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.manifolds import Sphere as TSphere
from riptrm_torch.manifolds import Stiefel as TStiefel
from riptrm_torch.manifolds import base as tbase
from riptrm_torch.ops import basis as tb
from riptrm_torch.ops import spectrum as tspec
from riptrm_torch.problems import bounded_pca as tbp
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers.riptrm import _barrier_ops as t_barrier_ops
from riptrm_tpu.manifolds import Sphere as JSphere
from riptrm_tpu.manifolds import Stiefel as JStiefel
from riptrm_tpu.manifolds import base as jbase
from riptrm_tpu.ops import basis as jb
from riptrm_tpu.ops import spectrum as jspec
from riptrm_tpu.problems import bounded_pca as jbp
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers.riptrm import _barrier_ops as j_barrier_ops

torch.set_num_threads(1)

ATOL = 1e-12
B = 3
MANIFOLDS = {"sphere": (TSphere(9), JSphere(9)), "stiefel": (TStiefel(7, 3), JStiefel(7, 3))}


def _points(name, seed=0):
    """B points and B tangents at them, from numpy."""
    rng = np.random.default_rng(seed)
    if name == "sphere":
        x = rng.standard_normal((B, 9))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        a = rng.standard_normal((B, 9))
        u = a - np.sum(a * x, 1, keepdims=True) * x
    else:
        x = np.linalg.qr(rng.standard_normal((B, 7, 3)))[0]
        a = rng.standard_normal((B, 7, 3))
        xa = np.einsum("bji,bjk->bik", x, a)
        u = a - x @ (0.5 * (xa + xa.transpose(0, 2, 1)))
    return x, u


@pytest.mark.parametrize("name", MANIFOLDS)
def test_basis_orthonormal_and_round_trips(name):
    """basis(x) is metric-orthonormal and tangent at x; to_coords and
    from_coords invert each other (atol 1e-12); flat_dim counts one lane."""
    tm, jm = MANIFOLDS[name]
    x, u = _points(name)
    tx, tu = torch.tensor(x), torch.tensor(u)
    basis = tm.basis(tx)
    assert basis.shape == (B, tm.dim) + x.shape[1:]
    flat = basis.reshape(B, tm.dim, -1)
    gram = flat @ flat.mT
    np.testing.assert_allclose(gram.numpy(), np.broadcast_to(np.eye(tm.dim), gram.shape),
                               atol=ATOL)
    # every basis vector is tangent: its projection is itself
    np.testing.assert_allclose(tm.proj(tx[:, None], basis).numpy(), basis.numpy(), atol=ATOL)
    c = tm.to_coords(tx, basis, tu)
    np.testing.assert_allclose(tm.from_coords(tx, basis, c).numpy(), u, atol=ATOL)
    np.testing.assert_allclose(tm.to_coords(tx, basis, tm.from_coords(tx, basis, c)).numpy(),
                               c.numpy(), atol=ATOL)
    assert tm.flat_dim(tx) == jm.flat_dim(jnp.asarray(x[0]))
    # the coordinate norm is the metric norm (sign-free, so held to JAX too)
    for i in range(B):
        jc = jm.to_coords(jnp.asarray(x[i]), jm.basis(jnp.asarray(x[i])), jnp.asarray(u[i]))
        np.testing.assert_allclose(np.linalg.norm(c[i].numpy()), np.linalg.norm(jc), rtol=1e-12)


def test_sphere_basis_equals_jax():
    """The Householder basis is deterministic: the same rows as JAX's, and
    the same coordinates, atol 1e-12."""
    tm, jm = MANIFOLDS["sphere"]
    x, u = _points("sphere", seed=1)
    tx = torch.tensor(x)
    basis = tm.basis(tx)
    for i in range(B):
        jbasis = jm.basis(jnp.asarray(x[i]))
        np.testing.assert_allclose(basis[i].numpy(), np.asarray(jbasis), atol=ATOL)
        np.testing.assert_allclose(
            tm.to_coords(tx, basis, torch.tensor(u))[i].numpy(),
            np.asarray(jm.to_coords(jnp.asarray(x[i]), jbasis, jnp.asarray(u[i]))), atol=ATOL)


@pytest.mark.parametrize("d", [1, 3, 4])
def test_sym_skew_bases_and_completion_equal_jax(d):
    """_sym_basis/_skew_basis are the JAX package's (exactly); the
    orthonormal completion is orthonormal and orthogonal to x (atol
    1e-12)."""
    np.testing.assert_array_equal(tbase._sym_basis(d, device="cpu").numpy(),
                                  np.asarray(jbase._sym_basis(d)))
    np.testing.assert_array_equal(tbase._skew_basis(d, device="cpu").numpy(),
                                  np.asarray(jbase._skew_basis(d)).reshape(-1, d, d))
    x = torch.tensor(np.linalg.qr(np.random.default_rng(d).standard_normal((B, 8, d)))[0])
    xp = tbase.orthonormal_completion(x)
    assert xp.shape == (B, 8, 8 - d)
    np.testing.assert_allclose((xp.mT @ xp).numpy(),
                               np.broadcast_to(np.eye(8 - d), (B, 8 - d, 8 - d)), atol=ATOL)
    np.testing.assert_allclose((x.mT @ xp).numpy(), 0.0, atol=ATOL)


@pytest.mark.parametrize("name", MANIFOLDS)
def test_materialize_symmetrized_matches_jax(name):
    """The projected symmetric operator op(v) = P(A v) materialised in both
    packages: equal matrices on the sphere (atol 1e-10), equal spectra on
    Stiefel (atol 1e-10); every lane's spectrum is the ambient P A P's on
    the tangent space."""
    tm, jm = MANIFOLDS[name]
    x, _ = _points(name, seed=2)
    rng = np.random.default_rng(7)
    n_amb = int(np.prod(x.shape[1:]))
    a = rng.standard_normal((n_amb, n_amb))
    a = a + a.T
    ta = torch.tensor(a)
    tx = torch.tensor(x)

    def t_op(v):
        return tm.proj(tx, (v.reshape(B, -1) @ ta).reshape(v.shape))

    m = tb.materialize_symmetrized(tm, tx, tm.basis(tx), t_op)
    assert m.shape == (B, tm.dim, tm.dim)
    for i in range(B):
        xi = jnp.asarray(x[i])

        def j_op(v, xi=xi):
            return jm.proj(xi, (jnp.asarray(a) @ v.reshape(-1)).reshape(v.shape))

        jm_mat = np.asarray(jb.materialize_symmetrized(jm, xi, jm.basis(xi), j_op))
        if name == "sphere":
            np.testing.assert_allclose(m[i].numpy(), jm_mat, atol=1e-10)
        np.testing.assert_allclose(np.linalg.eigvalsh(m[i].numpy()), np.linalg.eigvalsh(jm_mat),
                                   atol=1e-10)
    # materialize (unsymmetrised) represents the same operator
    raw = tb.materialize(tm, tx, tm.basis(tx), t_op)
    np.testing.assert_allclose(0.5 * (raw + raw.mT).numpy(), m.numpy(), atol=ATOL)


def _sphere_problem(n=23, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, n))
    x0 = np.abs(rng.standard_normal(n))
    x0 /= np.linalg.norm(x0)
    return z, x0


@pytest.mark.parametrize("weights", ["barrier", "none"])
def test_householder_congruence_matches_hvp_path_and_jax(weights):
    """The sphere's closed form (``Problem.hessian_coords_at``, one
    Householder congruence) against the port's HVP materialisation (atol
    1e-10) and against JAX's congruence (atol 1e-12), at B = 3 lanes: with
    the barrier weights y/c and cx's coordinates (RIPTRM's exact mode), and
    without them, with the constraint rows -B' (``ineq_rows_at``; RSQO)."""
    z, x0 = _sphere_problem()
    n = z.shape[0]
    tp = tn.make_problem(z, x0, device="cpu")
    jp = jn.make_problem(z, x0)
    rng = np.random.default_rng(5)
    xs = np.abs(rng.standard_normal((B, n)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    ys = np.abs(rng.standard_normal((B, n))) + 0.1
    mu = np.array([0.3, 0.05, 1e-3])
    tx, ty, tmu = torch.tensor(xs), torch.tensor(ys), torch.tensor(mu)
    man = tp.manifold
    basis = man.basis(tx)
    closed = tp.hessian_coords_at(tx, ty)
    jzs = jp.structure["Zs"]
    if weights == "barrier":
        c, hw, cx = t_barrier_ops(tp, tx, ty, tmu)
        h_ref = tb.materialize_symmetrized(man, tx, basis, hw)
        c_ref = tb.covector(man, tx, basis, cx)
        h_fast, c_fast = closed(ty / c, tmu[:, None] / c)
        np.testing.assert_allclose(c_fast.numpy(), c_ref.numpy(), atol=1e-10)
    else:
        h_ref = tb.materialize_symmetrized(man, tx, basis, tp.lag_rhess_at(tx, ty))
        h_fast, c_fast = closed()
        assert c_fast is None
        rows = tb.constraint_grad_rows(man, tx, basis, tp.ineq_fn, n)
        np.testing.assert_allclose(tp.ineq_rows_at(tx, basis).numpy(), rows.numpy(),
                                   atol=1e-12)
    np.testing.assert_allclose(h_fast.numpy(), h_ref.numpy(), atol=1e-10)
    for i in range(B):
        xi, yi = jnp.asarray(xs[i]), jnp.asarray(ys[i])
        jc, _, _ = j_barrier_ops(jp, xi, yi, jnp.asarray(mu[i]))
        ja = -2.0 * jzs + (jnp.diag(yi / jc) if weights == "barrier" else 0.0)
        jk = xi @ (-2.0 * (jzs @ xi) - yi)
        np.testing.assert_allclose(h_fast[i].numpy(),
                                   np.asarray(jb.sphere_householder_congruence(xi, ja, jk)),
                                   atol=ATOL)
        if weights == "barrier":
            np.testing.assert_allclose(
                c_fast[i].numpy(),
                np.asarray(jb.sphere_householder_coords(xi, -2.0 * (jzs @ xi) - mu[i] / jc)),
                atol=ATOL)


@pytest.mark.parametrize("which", ["rhess", "lag_rhess"])
def test_hessian_vector_products_match_jax(which):
    """Problem.rhess and Problem.lag_rhess on BoundedPCA St(30, 3) against
    JAX (rtol 1e-12), and lag_rhess against the frozen lag_rhess_at."""
    tp = tbp.load_problem("dataset/BoundedPCA/1", "a", device="cpu")
    jp = jbp.load_problem("dataset/BoundedPCA/1", "a")
    x = tp.x0[None]
    rng = np.random.default_rng(11)
    y = np.abs(rng.standard_normal((1, tp.num_ineq)))
    v = tp.manifold.proj(x, torch.tensor(rng.standard_normal(x.shape)))
    ty = torch.tensor(y)
    if which == "rhess":
        got = tp.rhess(x, v)
        want = jp.rhess(jp.x0, jnp.asarray(v[0].numpy()))
    else:
        got = tp.lag_rhess(x, ty, v)
        want = jp.lag_rhess(jp.x0, jnp.asarray(y[0]), jnp.asarray(v[0].numpy()))
        np.testing.assert_allclose(got.numpy(), tp.lag_rhess_at(x, ty)(v).numpy(),
                                   rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("descending_abs", [True, False])
def test_hessian_spectrum_matches_jax(descending_abs):
    """hessian_spectrum at the golden NonnegPCA x0: the JAX eigenvalues
    (atol 1e-10), and each returned tangent vector satisfies the eigen
    equation (atol 1e-10)."""
    tp = tn.load_problem("dataset/NonnegPCA/1", "a", device="cpu")
    jp = jn.load_problem("dataset/NonnegPCA/1", "a")
    x = tp.x0[None]
    w, vecs = tspec.hessian_spectrum(tp, x, descending_abs=descending_abs)
    jw, _ = jspec.hessian_spectrum(jp, jp.x0, descending_abs=descending_abs)
    np.testing.assert_allclose(w[0].numpy(), np.asarray(jw), atol=1e-10)
    for i in (0, 1, tp.manifold.dim - 1):
        v = vecs[:, i]
        np.testing.assert_allclose(tp.rhess(x, v).numpy(), (w[:, i:i + 1] * v).numpy(),
                                   atol=1e-10)

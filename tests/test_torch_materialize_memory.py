"""Memory and parity of the port's dense tangent-space materialisation
(``riptrm_torch/ops/basis.py``: ``materialize``,
``materialize_symmetrized``, ``materialize_sharded``,
``constraint_grad_rows``; ``Manifold.coords_of_stack``).

Every dense path applies the operator to the basis directions and then
contracts the stacked results with the basis once.  A coordinate map
taken under the ``vmap`` over directions would instead broadcast the
lane-batched basis against every direction: a tensor dim times the basis
(253 MB for a 1.27 MB basis at Sphere(200), B = 4).

(a) The largest tensor any aten operator produces inside each function (a
``TorchDispatchMode`` that records the storage bytes of every output) is
at most ``BOUND`` = 3 times the larger of the lane-batched basis's bytes
and the stacked tangents' bytes (B dim ambient for the matrices, B m
ambient for the rows).  The operator is a projected linear map
op(v) = P(A v), whose own intermediates are no larger than the basis.
(b) One dense RIPM step and one RSQO step (chip_sweep's QP options) on
BoundedPCA St(16, 4), B = 4, under the same bound with m = 2 n p.
(c) float64: the matrices and rows against a plain column-by-column loop
of metric inner products (atol 1e-12), and against the JAX package's
``materialize_symmetrized`` and ``constraint_grad_rows`` lane by lane,
given the port's basis (atol 1e-10).

FixedRankEmbedded has no closed-form basis in either package; the tests
build an orthonormal one from the orthonormal completions of U and V.
Its ``egrad2rgrad`` takes the ambient m x n gradient, which a ``vjp`` in
the packed point does not give, so it has no constraint-row case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from riptrm_torch import manifolds as tm
from riptrm_torch.ops import basis as tb
from riptrm_torch.parallel.sweep import batched_solver_sweep
from riptrm_torch.problems import bounded_pca as tbp
from riptrm_tpu import manifolds as jm
from riptrm_tpu.ops import basis as jb

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

B = 4
BOUND = 3.0
SID_D = 4
FR = (8, 6, 2)  # FixedRankEmbedded(m, n, k)
CASES = {
    "sphere": (tm.Sphere(200), jm.Sphere(200)),
    "stiefel": (tm.Stiefel(16, 4), jm.Stiefel(16, 4)),
    "grassmann": (tm.Grassmann(12, 3), jm.Grassmann(12, 3)),
    "euclidean": (tm.Euclidean(6, 5), jm.Euclidean(6, 5)),
    "product": (tm.Product([tm.SkewSymmetric(SID_D), tm.SymmetricPositiveDefinite(SID_D),
                            tm.SymmetricPositiveDefinite(SID_D)]),
                jm.Product([jm.SkewSymmetric(SID_D), jm.SymmetricPositiveDefinite(SID_D),
                            jm.SymmetricPositiveDefinite(SID_D)])),
    "fixed_rank": (tm.FixedRankEmbedded(*FR), jm.FixedRankEmbedded(*FR)),
}
ROW_CASES = [name for name in CASES if name != "fixed_rank"]


class LargestOutput(TorchDispatchMode):
    """Records the largest storage, in bytes, of any aten operator's output
    while it is active, and the operator that made it."""

    def __init__(self):
        super().__init__()
        self.bytes, self.op = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().nbytes() > self.bytes:
                self.bytes, self.op = t.untyped_storage().nbytes(), str(func)
        return out


def _nbytes(t):
    if isinstance(t, (tuple, list)):
        return sum(_nbytes(a) for a in t)
    return t.numel() * t.element_size()


def _qr(rng, shape):
    return np.linalg.qr(rng.standard_normal(shape))[0]


def _spd(rng, d):
    q = _qr(rng, (d, d))
    return (q * (1.0 + rng.random(d))) @ q.T


def _point(name, seed=0):
    """B points of case ``name`` from numpy, in the port's packed layout."""
    rng = np.random.default_rng(seed)
    if name == "sphere":
        x = rng.standard_normal((B, 200))
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    if name == "stiefel":
        return np.stack([_qr(rng, (16, 4)) for _ in range(B)])
    if name == "grassmann":
        return np.stack([_qr(rng, (12, 3)) for _ in range(B)])
    if name == "euclidean":
        return rng.standard_normal((B, 6, 5))
    if name == "product":
        out = []
        for _ in range(B):
            a = rng.standard_normal((SID_D, SID_D))
            out.append(np.stack([0.5 * (a - a.T), _spd(rng, SID_D), _spd(rng, SID_D)]))
        return np.stack(out)
    m, n, k = FR
    out = []
    for _ in range(B):
        s = np.sort(np.abs(rng.standard_normal(k)))[::-1] + 0.5
        out.append(np.concatenate([_qr(rng, (m, k)).ravel(), s, _qr(rng, (n, k)).ravel()]))
    return np.stack(out)


def _fixed_rank_basis(man, x):
    """An orthonormal tangent basis [B, dim, (k + m + n) k] at x: M = E_ab,
    then Up = U_perp[:, a] e_b', then Vp = V_perp[:, a] e_b'."""
    m, n, k = FR
    u, _, v = man.unpack(x)
    up, vp = tm.base.orthonormal_completion(u), tm.base.orthonormal_completion(v)
    eye = torch.eye(k, dtype=x.dtype)
    zeros = lambda r: torch.zeros((B, r * k, k, k), dtype=x.dtype)
    z_m = lambda r: torch.zeros((B, r * k, m, k), dtype=x.dtype)
    z_n = lambda r: torch.zeros((B, r * k, n, k), dtype=x.dtype)
    mm = torch.eye(k * k, dtype=x.dtype).reshape(1, k * k, k, k).expand(B, -1, -1, -1)
    ups = torch.einsum("bia,jl->bajil", up, eye).reshape(B, (m - k) * k, m, k)
    vps = torch.einsum("bia,jl->bajil", vp, eye).reshape(B, (n - k) * k, n, k)
    parts = [torch.cat([mm, zeros(m - k), zeros(n - k)], 1),
             torch.cat([z_m(k), ups, z_m(n - k)], 1),
             torch.cat([z_n(k), z_n(m - k), vps], 1)]
    return man.pack_tangent(parts)


def _setup(name, seed=0):
    """(manifold, x, basis, op, the ambient size, A): op(v) = P(A v) with a
    symmetric A over the tangent's ambient entries."""
    man = CASES[name][0]
    x = torch.tensor(_point(name, seed))
    if name == "fixed_rank":
        basis = _fixed_rank_basis(man, x)
        size = FR[0] * FR[1]

        def op(v):
            z = man.embed_tangent(x, v).reshape(B, -1) @ a
            return man.proj(x, z.reshape(B, FR[0], FR[1]))
    else:
        basis = man.basis(x)
        size = int(np.prod(x.shape[1:]))

        def op(v):
            return man.proj(x, (v.reshape(B, -1) @ a).reshape(v.shape))
    a_np = np.random.default_rng(seed + 1).standard_normal((size, size))
    a = torch.tensor(a_np + a_np.T)
    return man, x, basis, op, size, a


def _constraints(name, seed=0):
    """(fn, m, W): a nonlinear per-lane constraint function tanh(W vec(x))
    with m = the point's size (200 on the sphere)."""
    size = int(np.prod(_point(name).shape[1:]))
    w = torch.tensor(np.random.default_rng(seed + 2).standard_normal((size, size)) / size**0.5)
    return (lambda xx: torch.tanh(w @ xx.reshape(-1))), size, w


def _bound(basis, stacked):
    return BOUND * max(_nbytes(basis), _nbytes(stacked))


@pytest.mark.parametrize("which", ["materialize", "materialize_symmetrized"])
@pytest.mark.parametrize("name", list(CASES))
def test_materialize_largest_tensor_is_basis_sized(name, which):
    """Inside ``materialize``/``materialize_symmetrized`` no tensor exceeds
    3x the larger of the basis and the stacked tangents op(basis_j)."""
    man, x, basis, op, _, _ = _setup(name)
    with LargestOutput() as rec:
        a = getattr(tb, which)(man, x, basis, op)
    stacked = torch.empty((B, man.dim) + tuple(man.tangent_shape), dtype=x.dtype)
    assert a.shape == (B, man.dim, man.dim)
    assert rec.bytes <= _bound(basis, stacked), (rec.bytes, rec.op, _bound(basis, stacked))


@pytest.mark.parametrize("name", ROW_CASES)
def test_constraint_rows_largest_tensor_is_rows_sized(name):
    """Inside ``constraint_grad_rows`` no tensor exceeds 3x the larger of
    the basis and the stacked Riemannian gradients [B, m, ambient]."""
    man, x, basis, _, _, _ = _setup(name)
    fn, m, _ = _constraints(name)
    with LargestOutput() as rec:
        g = tb.constraint_grad_rows(man, x, basis, fn, m)
    assert g.shape == (B, m, man.dim)
    stacked = torch.empty((B, m) + tuple(man.tangent_shape), dtype=x.dtype)
    assert rec.bytes <= _bound(basis, stacked), (rec.bytes, rec.op, _bound(basis, stacked))


@pytest.mark.parametrize("name", list(CASES))
def test_materialize_sharded_one_rank_is_basis_sized(name, tmp_path):
    """``materialize_sharded`` on a one-rank gloo group: equal to
    ``materialize`` and under the same bound."""
    import torch.distributed as dist

    from riptrm_torch.parallel.sweep import make_mesh

    man, x, basis, op, _, _ = _setup(name)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh({"tp": 1}, device="cpu")
        with LargestOutput() as rec:
            a = tb.materialize_sharded(man, x, basis, op, mesh, axis="tp")
    finally:
        dist.destroy_process_group()
    stacked = torch.empty((B, man.dim) + tuple(man.tangent_shape), dtype=x.dtype)
    assert rec.bytes <= _bound(basis, stacked), (rec.bytes, rec.op, _bound(basis, stacked))
    np.testing.assert_array_equal(a.numpy(), tb.materialize(man, x, basis, op).numpy())


def _bpca(seed=0):
    """BoundedPCA St(16, 4) from numpy and B feasible starts, float64."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((16, 16))
    xs = np.stack([_qr(rng, (16, 4)) for _ in range(B)])
    assert np.abs(xs).max() < 0.8
    p = tbp.make_problem(z, xs[0], dtype=torch.float64, device="cpu")
    return p, torch.tensor(xs), torch.ones((B, p.num_ineq), dtype=torch.float64)


@pytest.mark.parametrize("solver,option", [
    ("RIPM", {}),
    ("RSQO", {"quadoptim_type": "reghess_shift", "quadoptim_linear_solver": "schulz"}),
])
def test_baseline_step_on_bounded_pca_is_rows_sized(solver, option):
    """One dense RIPM step and one RSQO step on BoundedPCA St(16, 4), B = 4
    (m = 128 bound constraints), through ``batched_solver_sweep``: no
    tensor above 3x the larger of the basis and the stacked constraint
    gradients [B, m, n, p]; every lane finite."""
    p, xs, ys = _bpca()
    run = batched_solver_sweep(p, solver, {"maxiter": 1, "tolresid": 1e-12} | option, 1)
    with LargestOutput() as rec:
        _, _, steps, res = run(xs, ys)
    basis = torch.empty((B, p.manifold.dim, 16, 4), dtype=torch.float64)
    stacked = torch.empty((B, p.num_ineq, 16, 4), dtype=torch.float64)
    assert rec.bytes <= _bound(basis, stacked), (rec.bytes, rec.op, _bound(basis, stacked))
    assert bool(torch.all(steps == 1)) and bool(torch.all(torch.isfinite(res)))


def _loop_coords(man, x, basis, vs):
    """Coordinates [B, K, dim] of the tangents vs [B, K, ...], one basis
    vector at a time by the metric inner product."""
    eye = torch.eye(man.dim, dtype=x.dtype)
    cols = []
    for i in range(man.dim):
        b_i = man.from_coords(x, basis, eye[i].expand(B, -1))
        cols.append(torch.stack([man.inner(x, b_i, vs[:, k]) for k in range(vs.shape[1])], 1))
    return torch.stack(cols, -1)


@pytest.mark.parametrize("name", list(CASES))
def test_materialize_matches_column_loop_and_jax(name):
    """``materialize`` against the matrix built column by column
    (op(basis_j), then <basis_i, .> for each i; atol 1e-12), and
    ``materialize_symmetrized`` against the JAX package's on each lane,
    given the same basis (atol 1e-10)."""
    man, x, basis, op, _, a = _setup(name)
    got = tb.materialize(man, x, basis, op)
    eye = torch.eye(man.dim, dtype=x.dtype)
    cols = torch.stack([op(man.from_coords(x, basis, eye[j].expand(B, -1)))
                        for j in range(man.dim)], 1)
    want = _loop_coords(man, x, basis, cols).mT
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
    sym = tb.materialize_symmetrized(man, x, basis, op)
    jman, a_np = CASES[name][1], a.numpy()
    for i in range(B):
        xi, bi = _to_jax(name, man, x[i:i + 1], basis[i:i + 1] if torch.is_tensor(basis)
                         else tuple(c[i:i + 1] for c in basis))
        j_op = _jax_op(name, jman, xi, jnp.asarray(a_np))
        jmat = np.asarray(jb.materialize_symmetrized(jman, xi, bi, j_op))
        np.testing.assert_allclose(sym[i].numpy(), jmat, atol=1e-10)


@pytest.mark.parametrize("name", ROW_CASES)
def test_constraint_rows_match_column_loop_and_jax(name):
    """``constraint_grad_rows`` of tanh(W vec(x)) against the rows built one
    constraint at a time (the Riemannian gradient of fn_i, then its
    coordinates by inner products; atol 1e-12), and against the JAX
    package's on each lane, given the same basis (atol 1e-10)."""
    man, x, basis, _, _, _ = _setup(name)
    fn, m, w = _constraints(name)
    got = tb.constraint_grad_rows(man, x, basis, fn, m)
    grads = []
    for i in range(m):
        xx = x.clone().requires_grad_(True)
        (eg,) = torch.autograd.grad(torch.func.vmap(fn)(xx)[:, i].sum(), xx)
        grads.append(man.egrad2rgrad(x, eg))
    want = _loop_coords(man, x, basis, torch.stack(grads, 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
    jman, w_np = CASES[name][1], jnp.asarray(w.numpy())
    for i in range(B):
        xi, bi = _to_jax(name, man, x[i:i + 1], basis[i:i + 1] if torch.is_tensor(basis)
                         else tuple(c[i:i + 1] for c in basis))
        j_fn = _jax_flat_fn(name, w_np)
        jrows = np.asarray(jb.constraint_grad_rows(jman, xi, bi, j_fn, m))
        np.testing.assert_allclose(got[i].numpy(), jrows, atol=1e-10)


def _to_jax(name, man, x, basis):
    """One lane's point and basis ([1, ...] in the port) in the JAX
    package's layout: tuples for the Product and the fixed-rank triples."""
    if name == "product":
        return (tuple(jnp.asarray(c[0].numpy()) for c in man.unpack(x)),
                tuple(jnp.asarray(c[0].numpy()) for c in basis))
    if name == "fixed_rank":
        return (tuple(jnp.asarray(c[0].numpy()) for c in man.unpack(x)),
                tuple(jnp.asarray(c[0].numpy()) for c in man.unpack_tangent(basis)))
    return jnp.asarray(x[0].numpy()), jnp.asarray(basis[0].numpy())


def _jax_flat(name, v):
    if name == "product":
        return jnp.concatenate([c.reshape(-1) for c in v])
    return v.reshape(-1)


def _jax_op(name, jman, xi, a):
    """The JAX package's op(v) = P(A v) on one lane."""
    if name == "fixed_rank":
        return lambda v: jman.proj(xi, (a @ jman.embed_tangent(xi, v).reshape(-1))
                                   .reshape(FR[0], FR[1]))
    if name == "product":
        def op(v):
            av = a @ _jax_flat(name, v)
            return jman.proj(xi, tuple(av[i * SID_D**2:(i + 1) * SID_D**2].reshape(SID_D, SID_D)
                                       for i in range(3)))
        return op
    return lambda v: jman.proj(xi, (a @ v.reshape(-1)).reshape(v.shape))


def _jax_flat_fn(name, w):
    return lambda xx: jnp.tanh(w @ _jax_flat(name, xx))

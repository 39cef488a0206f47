"""Grassmann, Symmetric, SkewSymmetric, SPD, Product and FixedRankEmbedded
of the PyTorch port against ``riptrm_tpu``, float64 on the CPU.

For the same numpy inputs over B = 2 lanes (the JAX functions ``vmap``ped
over them), every operation of ``Grassmann(6, 2)``, ``Symmetric(4)``,
``SkewSymmetric(4)``, ``SymmetricPositiveDefinite(4)``,
``Product(Skew(3), SPD(3), SPD(3))`` and ``FixedRankEmbedded(8, 6, 2)``:
``inner``, ``norm``, ``proj``, ``retract``, ``egrad2rgrad``,
``ehess2rhess``, ``transport``, ``dist``, ``basis``/``to_coords``/
``from_coords`` (where a basis exists) and ``embed_point``/
``embed_tangent``/``proj_tangent`` (fixed rank).  Tolerance: rtol 1e-10,
atol 1e-12 (a few flops deep; the SVDs, QRs and Cholesky factors of the
two packages agree to ~1e-14 here).  Grassmann's basis comes from a
complete QR whose column signs each library picks, so its basis vectors
and coordinates are compared up to one sign per basis vector.  The
fixed-rank retraction's factors are compared through the matrix they
represent (its SVD's signs are the library's).  The packed layout
round-trips (``pack``/``unpack``), and ``map_basis`` on a Product equals a
``vmap`` over the materialised block-diagonal basis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch import manifolds as tm
from riptrm_torch.ops.basis import materialize
from riptrm_tpu import manifolds as jm

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12
B = 2


def _spd(rng, d):
    a = rng.standard_normal((B, d, d))
    return a @ a.transpose(0, 2, 1) / d + np.eye(d)


def _sym(rng, d):
    a = rng.standard_normal((B, d, d))
    return 0.5 * (a + a.transpose(0, 2, 1))


def _skew(rng, d):
    a = rng.standard_normal((B, d, d))
    return 0.5 * (a - a.transpose(0, 2, 1))


def _frame(rng, n, p):
    return np.linalg.qr(rng.standard_normal((B, n, p)))[0]


def case(name):
    """(jax manifold, torch manifold, x, ambient u, ambient v, ambient
    egrad, ehess) with the points and ambient arrays as numpy tuples of
    components, each [B, ...]."""
    rng = np.random.default_rng(NAMES.index(name))
    if name == "grassmann":
        x = (_frame(rng, 6, 2),)
        amb = lambda: (rng.standard_normal((B, 6, 2)),)
        return jm.Grassmann(6, 2), tm.Grassmann(6, 2), x, amb(), amb(), amb(), amb()
    if name == "symmetric":
        amb = lambda: (_sym(rng, 4),)
        return jm.Symmetric(4), tm.Symmetric(4), amb(), amb(), amb(), amb(), amb()
    if name == "skew":
        amb = lambda: (rng.standard_normal((B, 4, 4)),)
        return jm.SkewSymmetric(4), tm.SkewSymmetric(4), (_skew(rng, 4),), amb(), amb(), \
            amb(), amb()
    if name == "spd":
        amb = lambda: (_sym(rng, 4),)
        return (jm.SymmetricPositiveDefinite(4), tm.SymmetricPositiveDefinite(4),
                (_spd(rng, 4),), amb(), amb(), amb(), amb())
    if name == "product":
        jp = jm.Product([jm.SkewSymmetric(3), jm.SymmetricPositiveDefinite(3),
                         jm.SymmetricPositiveDefinite(3)])
        tp = tm.Product([tm.SkewSymmetric(3), tm.SymmetricPositiveDefinite(3),
                         tm.SymmetricPositiveDefinite(3)])
        x = (_skew(rng, 3), _spd(rng, 3), _spd(rng, 3))
        amb = lambda: (_skew(rng, 3), _sym(rng, 3), _sym(rng, 3))
        return jp, tp, x, amb(), amb(), amb(), amb()
    if name == "fixed_rank":
        m, n, k = 8, 6, 2
        x = (_frame(rng, m, k), np.array([[3.0, 1.5], [2.0, 0.7]]), _frame(rng, n, k))
        amb = lambda: rng.standard_normal((B, m, n))
        return (jm.FixedRankEmbedded(m, n, k), tm.FixedRankEmbedded(m, n, k), x, amb(),
                amb(), amb(), amb())
    raise KeyError(name)


NAMES = ["grassmann", "symmetric", "skew", "spd", "product", "fixed_rank"]
BASIS_NAMES = NAMES[:-1]  # the fixed-rank manifold has none


def _j(parts, single):
    """numpy components -> the JAX package's point (a tuple or one array)."""
    arrs = tuple(jnp.asarray(a) for a in parts)
    return arrs[0] if single else arrs


def _leaves(a):
    return [np.asarray(v) for v in (a if isinstance(a, tuple) else (a,))]


def close(t, j, msg=""):
    for a, b in zip(t, j, strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=msg)


class Pair:
    """One manifold in both packages, with the lane-mapped JAX ops."""

    def __init__(self, name):
        self.name = name
        self.jman, self.tman, x, u, v, eg, eh = case(name)
        self.fixed = name == "fixed_rank"
        self.single = len(x) == 1
        self.jx = _j(x, self.single)
        self.tx = self.tman.pack(tuple(torch.tensor(a) for a in x))
        if self.fixed:  # ambient arrays are [B, m, n] matrices
            self.ju, self.jv = jnp.asarray(u), jnp.asarray(v)
            self.jeg, self.jeh = jnp.asarray(eg), jnp.asarray(eh)
            self.tu, self.tv = torch.tensor(u), torch.tensor(v)
            self.teg, self.teh = torch.tensor(eg), torch.tensor(eh)
        else:
            self.ju, self.jv, self.jeg, self.jeh = (_j(a, self.single) for a in (u, v, eg, eh))
            self.tu, self.tv, self.teg, self.teh = (
                self.tman.pack(tuple(torch.tensor(b) for b in a)) for a in (u, v, eg, eh))

    def jmap(self, fn, *args):
        return jax.vmap(fn)(*args)

    def t_parts(self, t, tangent=True):
        """A packed torch value as numpy components."""
        parts = self.tman.unpack_tangent(t) if tangent else self.tman.unpack(t)
        return [p.numpy() for p in (parts if isinstance(parts, tuple) else (parts,))]

    def tangents(self):
        """Two tangents at x in each package: the projections of u and v."""
        jt = (self.jmap(self.jman.proj, self.jx, self.ju),
              self.jmap(self.jman.proj, self.jx, self.jv))
        tt = (self.tman.proj(self.tx, self.tu), self.tman.proj(self.tx, self.tv))
        return jt, tt


@pytest.fixture(params=NAMES)
def pair(request):
    return Pair(request.param)


def test_pack_round_trip(pair):
    parts = pair.tman.unpack(pair.tx)
    parts = parts if isinstance(parts, tuple) else (parts,)
    for a, b in zip(parts, _leaves(pair.jx), strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    assert torch.equal(pair.tman.pack(pair.tman.unpack(pair.tx)), pair.tx)
    assert tuple(pair.tx.shape[1:]) == tuple(pair.tman.point_shape)
    # one lane's view, as a problem's per-lane functions see it
    lane = pair.tman.unpack(pair.tx[1])
    lane = lane if isinstance(lane, tuple) else (lane,)
    for a, b in zip(lane, _leaves(pair.jx)):
        np.testing.assert_array_equal(a.numpy(), b[1])


def test_proj_inner_norm(pair):
    (ja, jb), (ta, tb) = pair.tangents()
    assert tuple(ta.shape[1:]) == tuple(pair.tman.tangent_shape)
    close(pair.t_parts(ta), _leaves(ja), "proj")
    close([pair.tman.inner(pair.tx, ta, tb)], [pair.jmap(pair.jman.inner, pair.jx, ja, jb)],
          "inner")
    close([pair.tman.norm(pair.tx, ta)], [pair.jmap(pair.jman.norm, pair.jx, ja)], "norm")


def test_retract_and_dist(pair):
    (ja, _), (ta, _) = pair.tangents()
    scale = 0.3
    jy = pair.jmap(lambda x, t: pair.jman.retract(x, jax.tree.map(lambda a: scale * a, t)),
                   pair.jx, ja)
    ty = pair.tman.retract(pair.tx, scale * ta)
    if pair.fixed:
        close([pair.tman.embed_point(ty)], [pair.jmap(pair.jman.embed_point, jy)], "retract")
        # the new factors are orthonormal and S is sorted, positive
        u, s, v = pair.tman.unpack(ty)
        eye = torch.eye(2, dtype=u.dtype)
        assert float(torch.abs(u.mT @ u - eye).max()) < 1e-13
        assert float(torch.abs(v.mT @ v - eye).max()) < 1e-13
        np.testing.assert_allclose(s.numpy(), np.asarray(jy[1]), rtol=RTOL)
    else:
        close(pair.t_parts(ty, tangent=False), _leaves(jy), "retract")
    close([pair.tman.dist(pair.tx, ty)], [pair.jmap(pair.jman.dist, pair.jx, jy)], "dist")


def test_gradient_and_hessian_conversions(pair):
    (ja, _), (ta, _) = pair.tangents()
    close(pair.t_parts(pair.tman.egrad2rgrad(pair.tx, pair.teg)),
          _leaves(pair.jmap(pair.jman.egrad2rgrad, pair.jx, pair.jeg)), "egrad2rgrad")
    close(pair.t_parts(pair.tman.ehess2rhess(pair.tx, pair.teg, pair.teh, ta)),
          _leaves(pair.jmap(pair.jman.ehess2rhess, pair.jx, pair.jeg, pair.jeh, ja)),
          "ehess2rhess")


def test_transport(pair):
    (ja, jb), (ta, tb) = pair.tangents()
    jy = pair.jmap(lambda x, t: pair.jman.retract(x, jax.tree.map(lambda a: 0.2 * a, t)),
                   pair.jx, jb)
    ty = pair.tman.retract(pair.tx, 0.2 * tb)
    out = pair.tman.transport(pair.tx, ty, ta)
    ref = pair.jmap(pair.jman.transport, pair.jx, jy, ja)
    if pair.fixed:  # the factors of y are the library's: compare embedded
        close([pair.tman.embed_tangent(ty, out)],
              [pair.jmap(pair.jman.embed_tangent, jy, ref)], "transport")
    else:
        close(pair.t_parts(out), _leaves(ref), "transport")


def _align(t, j):
    """Flip the sign of each basis vector of t [B, dim, ...] (numpy) to
    match j's."""
    tf, jf = t.reshape(t.shape[:2] + (-1,)), j.reshape(j.shape[:2] + (-1,))
    s = np.sign(np.sum(tf * jf, axis=-1))
    return t * s.reshape(s.shape + (1,) * (t.ndim - 2)), s


@pytest.mark.parametrize("name", BASIS_NAMES)
def test_basis_and_coordinates(name):
    pair = Pair(name)
    (ja, _), (ta, _) = pair.tangents()
    jbasis = pair.jmap(pair.jman.basis, pair.jx)
    tbasis = pair.tman.basis(pair.tx)
    jc = pair.jmap(pair.jman.to_coords, pair.jx, jbasis, ja)
    tc = pair.tman.to_coords(pair.tx, tbasis, ta)
    if pair.name == "grassmann":
        tb_np, signs = _align(tbasis.numpy(), np.asarray(jbasis))
        close([tb_np], [jbasis], "basis")
        close([tc.numpy() * signs], [jc], "to_coords")
    else:
        tb = tbasis if isinstance(tbasis, tuple) else (tbasis,)
        close(tb, _leaves(jbasis), "basis")
        close([tc], [jc], "to_coords")
    # from_coords inverts to_coords on tangents, in both packages alike
    close(pair.t_parts(pair.tman.from_coords(pair.tx, tbasis, tc)), _leaves(ja), "from_coords")
    c = np.random.default_rng(5).standard_normal((B, pair.jman.dim))
    jt = pair.jmap(pair.jman.from_coords, pair.jx, jbasis, jnp.asarray(c))
    tt = pair.tman.from_coords(pair.tx, tbasis, torch.tensor(c))
    if pair.name == "grassmann":
        tt = pair.tman.from_coords(pair.tx, tbasis, torch.tensor(c * signs))
    close(pair.t_parts(tt), _leaves(jt), "from_coords")


@pytest.mark.parametrize("name", BASIS_NAMES)
def test_basis_is_metric_orthonormal(name):
    pair = Pair(name)
    basis = pair.tman.basis(pair.tx)
    gram = materialize(pair.tman, pair.tx, basis, lambda v: v)
    eye = np.broadcast_to(np.eye(pair.tman.dim), gram.shape)
    np.testing.assert_allclose(gram.numpy(), eye, atol=1e-12)


def test_product_map_basis_matches_block_diagonal():
    p = Pair("product")
    basis = p.tman.basis(p.tx)
    op = lambda v: p.tman.ehess2rhess(p.tx, p.teg, v, v)
    got = p.tman.map_basis(basis, lambda b: p.tman.to_coords(p.tx, basis, op(b)), out_dims=2)
    # the block-diagonal basis, materialised here only to check
    dims = [m.dim for m in p.tman.manifolds]
    cols = []
    for k, bk in enumerate(basis):
        for j in range(dims[k]):
            parts = [torch.zeros_like(b[:, 0]) for b in basis]
            parts[k] = bk[:, j]
            cols.append(p.tman.to_coords(p.tx, basis, op(p.tman.pack(parts))))
    np.testing.assert_allclose(got.numpy(), torch.stack(cols, dim=2).numpy(), rtol=RTOL,
                               atol=ATOL)


def test_fixed_rank_embeddings_and_proj_tangent():
    p = Pair("fixed_rank")
    (ja, _), (ta, _) = p.tangents()
    close([p.tman.embed_point(p.tx)], [p.jmap(p.jman.embed_point, p.jx)], "embed_point")
    close([p.tman.embed_tangent(p.tx, ta)], [p.jmap(p.jman.embed_tangent, p.jx, ja)],
          "embed_tangent")
    drift = 1e-3 * torch.ones_like(ta)
    jdrift = jax.tree.map(lambda a: a + 1e-3, ja)
    close(p.t_parts(p.tman.proj_tangent(p.tx, ta + drift)),
          _leaves(p.jmap(p.jman.proj_tangent, p.jx, jdrift)), "proj_tangent")
    z = p.tman.zero_vector(p.tx)
    assert tuple(z.shape) == (B,) + p.tman.tangent_shape and not bool(z.any())


def test_fixed_rank_has_no_basis():
    p = Pair("fixed_rank")
    with pytest.raises(NotImplementedError):
        p.tman.basis(p.tx)
    with pytest.raises(NotImplementedError):
        p.jman.basis(jax.tree.map(lambda a: a[0], p.jx))


def test_spd_cholesky_nan_per_lane():
    """A lane whose point is not positive definite reads NaN in the
    metric (as ``jnp.linalg.cholesky`` gives it); the other lane is exact
    and nothing raises."""
    man = tm.SymmetricPositiveDefinite(3)
    x = torch.stack([torch.eye(3, dtype=torch.float64), -torch.eye(3, dtype=torch.float64)])
    u = torch.ones_like(x)
    val = man.inner(x, u, u)
    assert float(val[0]) == pytest.approx(9.0) and bool(torch.isnan(val[1]))
    jval = jm.SymmetricPositiveDefinite(3).inner(-jnp.eye(3), jnp.ones((3, 3)),
                                                 jnp.ones((3, 3)))
    assert bool(jnp.isnan(jval))
    assert bool(torch.isnan(man.retract(x, u)[1]).all())
    assert bool(torch.isnan(man.dist(x, x)[1]))


def test_product_rejects_fixed_rank_component():
    with pytest.raises(NotImplementedError):
        tm.Product([tm.FixedRankEmbedded(4, 3, 1), tm.Euclidean(2)])


def test_product_flat_layout():
    """Components of different shapes pack flat: Product(Sphere(3),
    Stiefel(4, 2)) against the JAX tuple."""
    rng = np.random.default_rng(9)
    s = rng.standard_normal((B, 3))
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    f = _frame(rng, 4, 2)
    jp = jm.Product([jm.Sphere(3), jm.Stiefel(4, 2)])
    tp = tm.Product([tm.Sphere(3), tm.Stiefel(4, 2)])
    tx = tp.pack((torch.tensor(s), torch.tensor(f)))
    assert tx.shape == (B, 11)
    amb = (rng.standard_normal((B, 3)), rng.standard_normal((B, 4, 2)))
    t = tp.proj(tx, tp.pack(tuple(torch.tensor(a) for a in amb)))
    jt = jax.vmap(jp.proj)((jnp.asarray(s), jnp.asarray(f)),
                           tuple(jnp.asarray(a) for a in amb))
    close([a for a in tp.unpack(t)], jt, "flat proj")
    close([tp.inner(tx, t, t)], [jax.vmap(jp.inner)((jnp.asarray(s), jnp.asarray(f)), jt, jt)],
          "flat inner")


@pytest.mark.parametrize("op", ["inner_at", "inner_at_same", "proj_tangent", "egrad2rgrad",
                                "ehess2rhess"])
def test_product_runs_equal_per_component(op):
    """Product(Skew(3), SPD(3), SPD(3)) runs its two SPD blocks as one call
    in the operators a tCG iteration applies: bitwise the per-component
    values, summed in the same order."""
    man = tm.Product([tm.SkewSymmetric(3), tm.SymmetricPositiveDefinite(3),
                      tm.SymmetricPositiveDefinite(3)])
    assert man._runs == [(man.manifolds[0], 0, 1), (man.manifolds[1], 1, 3)]
    g = torch.Generator().manual_seed(11)
    x = man.random_point(g, 4, dtype=torch.float64, device="cpu")
    u, v, e = (torch.randn(x.shape, generator=g, dtype=torch.float64) for _ in range(3))
    u, v = man.proj(x, u), man.proj(x, v)
    if op.startswith("inner_at"):
        w = u if op == "inner_at_same" else v
        got = man.inner_at(x)(u, w)
        want = sum(m.inner_at(xi)(ui, wi) for m, xi, ui, wi in man._zip(x, u, w))
    elif op == "ehess2rhess":
        got = man.ehess2rhess(x, e, u, v)
        want = man.pack(m.ehess2rhess(*a) for m, *a in man._zip(x, e, u, v))
    else:
        got = getattr(man, op)(x, e)
        want = man.pack(getattr(m, op)(xi, ei) for m, xi, ei in man._zip(x, e))
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["3d", "4d_slice", "transposed", "broadcast", "2d"])
def test_bmm_is_matmul(case):
    """``manifolds.base.bmm`` gives ``matmul``'s values bitwise: the same
    ``bmm`` on the same operands where both share a batch shape, and
    ``matmul`` itself elsewhere."""
    from riptrm_torch.manifolds.base import bmm

    g = torch.Generator().manual_seed(3)
    a = torch.randn(6, 3, 5, 5, generator=g, dtype=torch.float64)
    b = torch.randn(6, 3, 5, 5, generator=g, dtype=torch.float64)
    a, b = {"3d": (a[:, 0], b[:, 0]), "4d_slice": (a[:, 1:], b[:, 1:]),
            "transposed": (a[:, 1:].mT, b[:, :2]), "broadcast": (a[:, 0], b[0, 0]),
            "2d": (a[0, 0], b[0, 0])}[case]
    assert torch.equal(bmm(a, b), a @ b)

"""Rosenbrock, StableIdentification and LowRank of the PyTorch port against
``riptrm_tpu``, float64 on the CPU.

(a) On ``dataset/StableIdentification/1`` point a, ``rosenbrock.make_problem
    (5, 3)`` and ``dataset/LowRank/1`` point a: the cost, the constraint
    values, ``egrad`` (an ambient m x n matrix on LowRank), ``rgrad``,
    ``lag_rgrad``, ``lag_rhess_at``, ``rhess``, ``gx_at``, ``gx_adj`` and
    ``manvio`` at x0 and at a retracted point, with the same multipliers
    and directions; rtol 1e-10, atol 1e-12 times the value's largest
    magnitude (a handful of derivative evaluations through the same
    float64 algebra).  Rosenbrock's
    second-order-residual callback against JAX's, rtol 1e-8 (an SVD and an
    ``eigvalsh`` of a 6 x 6 matrix whose spectrum spans 1e7).
(b) The generators: ``parse_constset``, ``generate_constraints`` (with and
    without ``min_segment_width``), ``generate_trajectory`` and
    ``feasible_entry_targets`` equal the JAX functions' outputs exactly
    from the same ``np.random.default_rng`` seed; the parts the JAX
    package draws from ``jax.random`` are held to their properties: the
    true system skew / positive definite and Hurwitz, the lsq starts
    strictly interior and Hurwitz (several lanes in one call), the RALM
    search's start interior and Hurwitz, the
    low-rank instance nonnegative-ish of the right rank, its start
    strictly feasible with ordered singular values.
(c) The refusals of ``stable_identification.make_problem``: a mesh
    without the data axis, and a matmul precision other than None, 'high'
    and 'highest'.
(d) StableIdentification's closed-form derivatives against the port's own
    torch.func path, at 16 lanes near the shipped start, also under
    ``vmap`` over stacked directions (dense materialisation): rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.problems import low_rank as tl
from riptrm_torch.problems import rosenbrock as tr
from riptrm_torch.problems import stable_identification as ts
from riptrm_tpu.problems import low_rank as jl
from riptrm_tpu.problems import rosenbrock as jr
from riptrm_tpu.problems import stable_identification as js

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12
SID = "dataset/StableIdentification/1"
LOWRANK = "dataset/LowRank/1"
CPU = dict(dtype=torch.float64, device="cpu")


def _np(a):
    return [np.asarray(v) for v in (a if isinstance(a, tuple) else (a,))]


def close(t, j, msg="", rtol=RTOL, atol=ATOL):
    """A torch lane-0 value (packed or plain) against a JAX value; ``atol``
    is relative to the largest magnitude of the value (Rosenbrock's
    gradients reach 2e7, where an entry of order 1e-2 is a difference of
    such terms)."""
    for a, b in zip(t, _np(j), strict=True):
        scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol * scale,
                                   err_msg=msg)


class Family:
    def __init__(self, name):
        self.name = name
        if name == "sid":
            self.jp = js.load_problem(SID, "a")
            self.tp = ts.load_problem(SID, "a", **CPU)
        elif name == "rosenbrock":
            self.jp = jr.make_problem(5, 3)
            self.tp = tr.make_problem(5, 3, **CPU)
        else:
            self.jp = jl.load_problem(LOWRANK, "a")
            self.tp = tl.load_problem(LOWRANK, "a", **CPU)
        self.man = self.tp.manifold
        self.fixed = name == "lowrank"
        rng = np.random.default_rng(11)
        m = self.tp.num_ineq
        self.y = np.abs(rng.standard_normal(m)) + 0.1
        self.w = rng.standard_normal(m)
        # two directions: tangent projections of numpy ambient arrays
        shape = ((self.man.m, self.man.n) if self.fixed else self.man.point_shape)
        self.amb = [rng.standard_normal(shape) for _ in range(2)]

    def tparts(self, t, tangent=True):
        """Lane 0 of a packed torch value as numpy components."""
        parts = (self.man.unpack_tangent(t) if tangent else self.man.unpack(t))
        parts = parts if isinstance(parts, tuple) else (parts,)
        return [p[0].numpy() for p in parts]

    def jtree(self, arr):
        """A numpy array in the torch packed point layout -> JAX tree."""
        if self.name == "sid":
            return tuple(jnp.asarray(arr[i]) for i in range(3))
        return jnp.asarray(arr)

    def points(self):
        """(jax x, torch x [1, ...]) at x0 and at a retracted point."""
        jx0, tx0 = self.jp.x0, self.tp.x0[None]
        jt = self.jdir(jx0, 0)
        tt = self.tdir(tx0, 0)
        jx1 = self.jp.manifold.retract(jx0, jax.tree.map(lambda a: 0.05 * a, jt))
        tx1 = self.man.retract(tx0, 0.05 * tt)
        return [(jx0, tx0), (jx1, tx1)]

    def jdir(self, jx, i):
        amb = jnp.asarray(self.amb[i]) if self.fixed else self.jtree(self.amb[i])
        return self.jp.manifold.proj(jx, amb)

    def tdir(self, tx, i):
        return self.man.proj(tx, torch.tensor(self.amb[i])[None])


@pytest.fixture(scope="module", params=["sid", "rosenbrock", "lowrank"])
def fam(request):
    return Family(request.param)


def test_values_and_manvio(fam):
    for jx, tx in fam.points():
        close([fam.tp.cost(tx)[0]], jnp.asarray(fam.jp.cost(jx)), "cost")
        close([fam.tp.ineq_val(tx)[0]], fam.jp.ineq_val(jx), "ineq")
        close([fam.tp.manvio(tx)[0]], jnp.asarray(fam.jp.manvio(jx)), "manvio")
        # the packed point is the JAX point
        if fam.fixed:
            close([fam.man.embed_point(tx)[0]], fam.jp.manifold.embed_point(jx), "point")
        else:
            close(fam.tparts(tx, tangent=False), jx, "point")


def test_gradients(fam):
    y = fam.y
    for jx, tx in fam.points():
        ty = torch.tensor(y)[None]
        eg = fam.tp.egrad(tx)
        if fam.fixed:  # an ambient [B, m, n] matrix
            assert eg.shape == (1, fam.man.m, fam.man.n)
            close([eg[0]], fam.jp.egrad(jx), "egrad")
        else:
            close(fam.tparts(eg, tangent=False), fam.jp.egrad(jx), "egrad")
        close(fam.tparts(fam.tp.rgrad(tx)), fam.jp.rgrad(jx), "rgrad")
        close(fam.tparts(fam.tp.lag_rgrad(tx, ty)), fam.jp.lag_rgrad(jx, jnp.asarray(y)),
              "lag_rgrad")


def test_hessians(fam):
    y = fam.y
    for jx, tx in fam.points():
        ty = torch.tensor(y)[None]
        jv = fam.jdir(jx, 1)
        tv = fam.tdir(tx, 1)
        close(fam.tparts(fam.tp.lag_rhess_at(tx, ty)(tv)),
              fam.jp.lag_rhess_at(jx, jnp.asarray(y))(jv), "lag_rhess_at")
        close(fam.tparts(fam.tp.lag_rhess(tx, ty, tv)), fam.jp.lag_rhess(jx, jnp.asarray(y), jv),
              "lag_rhess")
        close(fam.tparts(fam.tp.rhess(tx, tv)), fam.jp.rhess(jx, jv), "rhess")


def test_constraint_jacobians(fam):
    w = fam.w
    for jx, tx in fam.points():
        jv = fam.jdir(jx, 1)
        tv = fam.tdir(tx, 1)
        close(fam.tparts(fam.tp.gx_at(tx)(torch.tensor(w)[None])),
              fam.jp.gx_at(jx)(jnp.asarray(w)), "gx_at")
        close([fam.tp.gx_adj(tx, tv)[0]], fam.jp.gx_adj(jx, jv), "gx_adj")
        close([fam.tp.gx_adj_at(tx)(tv)[0]], fam.jp.gx_adj_at(jx)(jv), "gx_adj_at")


def test_rosenbrock_second_order_residual():
    fam = Family("rosenbrock")
    for jx, tx in fam.points():
        ty = torch.tensor(fam.y)[None]
        mineig, cond = tr.second_order_residual(fam.tp, tx, ty, None)
        jmin, jcond = jr.second_order_residual(fam.jp, jx, jnp.asarray(fam.y),
                                               jnp.zeros((0,)))
        np.testing.assert_allclose(float(mineig[0]), float(jmin), rtol=1e-8)
        np.testing.assert_allclose(float(cond[0]), float(jcond), rtol=1e-8)
    # the callback reads it into the evaluation's metrics
    from riptrm_torch.ops.kkt import evaluation

    ev = evaluation(fam.tp, fam.tp.x0[None], fam.tp.x0[None], fam.tp.y0[None])
    assert "second_order_residual" in ev and "condition_number" in ev
    ev = evaluation(fam.tp, fam.tp.x0[None], fam.tp.x0[None], fam.tp.y0[None], callback=False)
    assert "second_order_residual" not in ev


def test_rosenbrock_sweep_starts_feasible():
    p = tr.make_problem(8, 3, **CPU)
    xs = tr.sweep_starts(p, torch.Generator().manual_seed(0), 4)
    assert xs.shape == (4, 8, 3)
    eye = torch.eye(3, dtype=xs.dtype)
    assert float(torch.abs(xs.mT @ xs - eye).max()) < 1e-12
    assert bool((p.slack(xs) > 0).all())
    assert not bool(torch.equal(xs[0], xs[1]))


# ---- generators ---------------------------------------------------------
def _true_a(d, seed=0):
    return js.generate_true_system(jax.random.PRNGKey(seed), d)[3]


def test_parse_constset_equal():
    constset = np.loadtxt(f"{SID}/constset.csv")
    for scaling in (1.0, 0.95):
        for a, b in zip(ts.parse_constset(constset, scaling),
                        js.parse_constset(constset, scaling), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_segment_width", [None, 0.05])
def test_generate_constraints_equal(min_segment_width):
    true_a = _true_a(8)
    got = ts.generate_constraints(np.random.default_rng(4), 8, true_a, 0.2, 0.1,
                                  min_segment_width=min_segment_width)
    want = js.generate_constraints(np.random.default_rng(4), 8, true_a, 0.2, 0.1,
                                   min_segment_width=min_segment_width)
    np.testing.assert_array_equal(got, want)


def test_trajectory_and_targets_equal():
    true_a = _true_a(5)
    got = ts.generate_trajectory(np.random.default_rng(2), 5, true_a, 0.02, 20, 10.0)
    want = js.generate_trajectory(np.random.default_rng(2), 5, true_a, 0.02, 20, 10.0)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    constset = js.generate_constraints(np.random.default_rng(0), 5, true_a, 0.2, 0.1)
    for a, b in zip(ts.feasible_entry_targets(constset), js.feasible_entry_targets(constset),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_true_system_properties():
    J, R, Q, A = ts.generate_true_system(torch.Generator().manual_seed(0), 4, **CPU)
    np.testing.assert_allclose(J, -J.T, atol=1e-12)
    assert np.min(np.linalg.eigvalsh(R)) > 0 and np.min(np.linalg.eigvalsh(Q)) > 0
    np.testing.assert_allclose(A, (J - R) @ Q, rtol=1e-14)
    assert np.all(np.real(np.linalg.eigvals(A)) < 0)
    # the box rows of the generated constraints hold at the true system (the
    # reference's annulus rows need not: k may exceed |aval - cc|)
    constset = ts.generate_constraints(np.random.default_rng(0), 4, A, 0.2, 0.1)
    X, _ = ts.generate_trajectory(np.random.default_rng(0), 4, A, 0.02, 10, 10.0)
    p = ts.make_problem(4, [X], constset, (J, R, Q), **CPU)
    kinds = ts.parse_constset(constset)[0]
    assert bool((p.ineq_val(p.x0[None])[0][torch.tensor(kinds != ts.KIND_TWO)] < 0).all())


def test_interior_initialpoint_lsq_lanes():
    """The lsq start search (d = 6, three starts as lanes of one conjugate
    gradient): every start strictly interior for the original constraints,
    Hurwitz, skew / positive definite."""
    d = 6
    true_a = _true_a(d)
    constset = js.generate_constraints(np.random.default_rng(0), d, true_a, 0.2, 0.1)
    J, R, Q, A = ts.generate_interior_initialpoint_lsq(
        torch.Generator().manual_seed(3), d, constset, lanes=3, cg_iters=400, **CPU)
    assert J.shape == (3, d, d)
    for i in range(3):
        p = ts.make_problem(d, [], constset, (J[i], R[i], Q[i]), cost_zero=True, **CPU)
        assert bool((p.ineq_val(p.x0[None]) < 0).all())
        assert np.all(np.real(np.linalg.eigvals(A[i])) < 0)
        np.testing.assert_allclose(J[i], -J[i].T, atol=1e-9)
        assert np.min(np.linalg.eigvalsh(R[i])) > 0 and np.min(np.linalg.eigvalsh(Q[i])) > 0


def test_interior_initialpoint_ralm():
    """The RALM feasibility search (the reference's generator, d = 3):
    interior for the original constraints and Hurwitz."""
    d = 3
    constset = js.generate_constraints(np.random.default_rng(0), d, _true_a(d), 0.2, 0.1)
    J, R, Q, A = ts.generate_interior_initialpoint(torch.Generator().manual_seed(0), d,
                                                   constset, **CPU)
    p = ts.make_problem(d, [], constset, (J, R, Q), cost_zero=True, **CPU)
    assert bool((p.ineq_val(p.x0[None]) <= 0).all())
    assert np.all(np.real(np.linalg.eigvals(A)) < 0)
    np.testing.assert_allclose(A, (J - R) @ Q, rtol=1e-14)


def test_low_rank_generators():
    g = torch.Generator().manual_seed(1)
    inst = tl.generate_instance(g, 9, 7, 2, **CPU)
    assert inst["A"].shape == (9, 7)
    s = torch.linalg.svdvals(inst["A"])
    assert float(s[2] / s[0]) < 0.05  # rank 2 plus small noise
    u, sv, v = tl.generate_initialpoint(g, 9, 7, 3, **CPU)
    assert u.shape == (9, 3) and sv.shape == (3,) and v.shape == (7, 3)
    assert bool((sv[:-1] >= sv[1:]).all()) and float(sv[-1]) > 0
    p = tl.make_problem(inst["A"], (u, sv, v))
    assert float(p.slack(p.x0[None]).min()) > 0.1 - 1e-12


class _DpOnlyMesh:
    mesh_dim_names, shape = ("dp",), (1,)


def test_sid_refusals():
    constset = np.loadtxt(f"{SID}/constset.csv")
    x0 = tuple(np.eye(5) for _ in range(3))
    traj = np.loadtxt(f"{SID}/noisyX_1.csv")
    with pytest.raises(ValueError, match="no axis 'tp'"):  # the data axis is missing
        ts.make_problem(5, [traj], constset, x0, mesh=_DpOnlyMesh(), **CPU)
    with pytest.raises(ValueError, match="matmul_precision"):
        ts.make_problem(5, [], constset, x0, cost_zero=True, matmul_precision="medium", **CPU)
    for precision in ("high", "highest"):
        ts.make_problem(5, [], constset, x0, cost_zero=True, matmul_precision=precision, **CPU)


@pytest.mark.parametrize("change,finite", [
    ("none", True), ("j_not_skew", True), ("r_negative_definite", False),
    ("q_singular", False), ("r_nan", False)])
def test_sid_manvio_off_the_manifold(change, finite):
    """StableIdentification's manifold violation off the manifold, against
    the JAX package's: the asymmetry's norm where R and Q are positive
    definite, inf where either is not (the port tests that by its
    Cholesky, the JAX package by its eigenvalues), not finite on a NaN."""
    jp, tp = js.load_problem(SID, "a"), ts.load_problem(SID, "a", **CPU)
    x = tp.x0[None].clone()
    if change == "j_not_skew":
        x[0, 0, 0, 1] += 1e-3
    elif change == "r_negative_definite":
        x[0, 1] = -x[0, 1]
    elif change == "q_singular":
        x[0, 2] = x[0, 2] - torch.linalg.eigvalsh(x[0, 2])[0] * torch.eye(5, dtype=x.dtype)
        x[0, 2, 0, 0] -= 1e-9
    elif change == "r_nan":
        x[0, 1, 0, 0] = float("nan")
    out = tp.manvio(x)[0]
    assert bool(torch.isfinite(out)) is finite
    if change != "r_nan":
        ref = jp.manvio(tuple(jnp.asarray(a.numpy()) for a in x[0]))
        close([out], jnp.asarray(ref), "manvio")


@pytest.mark.parametrize("op", ["lag_rhess_at", "lag_rhess_at_vmap", "gx_at", "gx_adj",
                                "gx_adj_at"])
def test_sid_closed_form_derivatives(op):
    import dataclasses

    from torch.func import vmap

    tp = ts.load_problem(SID, "a", **CPU)
    ad = dataclasses.replace(tp, derivatives=None)
    assert tp.derivatives is not None
    g = torch.Generator().manual_seed(5)
    man, lanes = tp.manifold, 16
    x = man.retract(tp.x0[None].expand(lanes, -1, -1, -1),
                    0.05 * man.random_tangent(tp.x0[None].expand(lanes, -1, -1, -1), g))
    y = torch.rand(lanes, tp.num_ineq, generator=g, dtype=torch.float64) + 0.1
    v = man.random_tangent(x, g)
    if op == "lag_rhess_at":
        got, want = tp.lag_rhess_at(x, y)(v), ad.lag_rhess_at(x, y)(v)
    elif op == "lag_rhess_at_vmap":
        vs = torch.stack([man.random_tangent(x, g) for _ in range(3)], dim=1)
        got, want = (vmap(p.lag_rhess_at(x, y), in_dims=1, out_dims=1)(vs) for p in (tp, ad))
    elif op == "gx_at":
        got, want = tp.gx_at(x)(y), ad.gx_at(x)(y)
    elif op == "gx_adj":
        got, want = tp.gx_adj(x, v), ad.gx_adj(x, v)
    else:
        got, want = tp.gx_adj_at(x)(v), ad.gx_adj_at(x)(v)
    close([got], want.numpy(), op, rtol=1e-12)

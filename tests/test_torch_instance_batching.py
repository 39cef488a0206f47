"""Instance batching in the port against ``riptrm_tpu``, on the CPU.

``instance_batched_riptrm`` solves B instances x starts as the lanes of one
problem whose per-lane data (``Problem.data``) is each lane's Zs or A.  The
same numpy inputs, made from a seed, go through the JAX function in
float64: NonnegPCA (n = 14, B = 4, the JAX test's sizes) lane by lane
against the JAX sweep and against the port's own one-instance solves (steps
within the JAX test's rule, 5 % + 3; points within atol 1e-6), the freeze
of early lanes, LowRank (8 x 6, rank 2, B = 2) with packed starts, and the
traced one-lane solve.  The routing test shows that a per-lane Zs never
reaches K3 or a multi-lane Stiefel launch: each lane is a one-lane launch
(the kernels' plain versions here) of its own instance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops import kernels as tk
from riptrm_torch.parallel import sweep as ts
from riptrm_torch.problems import bounded_pca as tb
from riptrm_torch.problems import low_rank as tl
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.parallel import sweep as js
from riptrm_tpu.problems import low_rank as jl
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import riptrm as jrm

torch.set_num_threads(1)

OPTION = {"maxiter": 25, "tolresid": 1e-8, "TRS_solver": "tCG",
          "second_order_stationarity": False}


def instances(b, n, seed=0):
    """B spiked Z (the generators' distribution) and feasible starts, numpy."""
    rng = np.random.default_rng(seed)
    zs = []
    for _ in range(b):
        v = (rng.permutation(n) < int(0.7 * n)) / np.sqrt(int(0.7 * n))
        zs.append(np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((n, n)) / np.sqrt(n))
    xs = np.abs(rng.standard_normal((b, n)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    return np.stack(zs), xs, np.ones((b, n))


@pytest.fixture(scope="module")
def nonneg():
    zs, xs, ys = instances(4, 14)
    out = ts.instance_batched_riptrm(OPTION, max_steps=500)(
        torch.tensor(zs), torch.tensor(xs), torch.tensor(ys))
    return zs, xs, ys, out


def test_instance_batched_matches_sequential(nonneg):
    zs, xs, ys, (xb, yb, kb, resb) = nonneg
    assert torch.all(resb < 1e-7)
    jxb, _, jkb, jresb = js.instance_batched_riptrm(OPTION, max_steps=500)(
        jnp.asarray(zs), jnp.asarray(xs), jnp.asarray(ys))
    solver = trm.RIPTRM(OPTION)
    for i in range(4):
        # the JAX package's lane
        assert abs(int(kb[i]) - int(jkb[i])) <= 0.05 * int(jkb[i]) + 3
        np.testing.assert_allclose(xb[i].numpy(), np.asarray(jxb[i]), atol=1e-6)
        # the port's own solve of this instance alone
        p = tn.make_problem(zs[i], xs[i], device="cpu")
        st, k = solver.solve_compiled(p, 500)(trm.init_state(p, solver.option))
        assert abs(int(k[0]) - int(kb[i])) <= 0.05 * int(k[0]) + 3
        np.testing.assert_allclose(xb[i].numpy(), st.x[0].numpy(), atol=1e-6)
    assert float(np.max(np.asarray(jresb))) < 1e-7


def test_batched_lanes_freeze_at_stop(nonneg):
    """Lanes stop on their own steps, and a lane's values are its own
    instance's: the first lane alone gives the same point."""
    zs, xs, ys, (xb, _, kb, resb) = nonneg
    assert torch.all(resb < 1e-7)
    assert len(set(kb.tolist())) > 1
    x1, _, k1, _ = ts.instance_batched_riptrm(OPTION, max_steps=500)(
        torch.tensor(zs[:1]), torch.tensor(xs[:1]), torch.tensor(ys[:1]))
    assert int(k1[0]) == int(kb[0])
    np.testing.assert_allclose(x1[0].numpy(), xb[0].numpy(), atol=1e-10)


def test_traced_compiled_solve():
    """Per-step trace buffers [B, max_steps]: rows up to each lane's stop,
    NaN / -1 after, the last row's residual the returned state's; the JAX
    trace of the same lane has the same statuses and outer iterations, and
    its residuals agree to a median relative 1e-8, and to 1e-3 on every row
    (a few rows near residual 1e-4 part by up to 5.8e-4 and rejoin)."""
    zs, xs, _ = instances(1, 14, seed=3)
    opt = OPTION | {"maxiter": 15, "tolresid": 1e-6}
    tp, jp = tn.make_problem(zs[0], xs[0], device="cpu"), jn.make_problem(zs[0], xs[0])
    solver = trm.RIPTRM(opt)
    st, k, trace = solver.solve_compiled_traced(tp, 300)(trm.init_state(tp, solver.option))
    k0 = int(k[0])
    res = trace["residual"][0].numpy()
    assert trace["residual"].shape == (1, 300) and k0 > 0
    assert res[k0 - 1] < res[0]
    assert np.isnan(res[k0:]).all() and np.isfinite(res[:k0]).all()
    assert (trace["outer_iter"][0, :k0] >= 0).all() and (trace["outer_iter"][0, k0:] == -1).all()
    assert (trace["inner_status"][0, k0:] == -1).all()
    from riptrm_torch.ops.kkt import compute_residual

    np.testing.assert_allclose(res[k0 - 1], float(compute_residual(tp, st.x, st.y)[0][0]),
                               rtol=1e-12)
    jsolver = jrm.RIPTRM(opt)
    _, jk, jtrace = jax.jit(jsolver.solve_compiled_traced(jp, 300))(
        jrm.init_state(jp, jsolver.option))
    assert k0 == int(jk)
    jres = np.asarray(jtrace["residual"])[:k0]
    rel = np.abs(res[:k0] - jres) / jres
    assert np.median(rel) < 1e-8 and rel.max() < 1e-3, rel
    np.testing.assert_array_equal(trace["outer_iter"][0].numpy(),
                                  np.asarray(jtrace["outer_iter"]))
    np.testing.assert_array_equal(trace["inner_status"][0].numpy(),
                                  np.asarray(jtrace["inner_status"]))


def test_low_rank_instance_batched_sweep():
    """LowRank instances x packed (U, S, V) starts through the builder hook,
    against the JAX sweep with tuple starts."""
    m, n, k, b = 8, 6, 2, 2
    rng = np.random.default_rng(5)
    data = np.stack([np.abs(rng.standard_normal((m, k))) @ np.abs(rng.standard_normal((n, k))).T
                     / np.sqrt(k) + 0.05 * rng.standard_normal((m, n)) for _ in range(b)])
    gen = torch.Generator().manual_seed(7)
    starts = [tl.generate_initialpoint(gen, m, n, k, dtype=torch.float64, device="cpu")
              for _ in range(b)]
    comps = tuple(torch.stack([s[i] for s in starts]) for i in range(3))
    opt = {"maxiter": 40, "tolresid": 1e-6, "TRS_solver": "tCG",
           "second_order_stationarity": False}
    man = tl.make_problem(data[0], tuple(c[0] for c in comps), device="cpu").manifold
    xs0 = man.pack(comps)
    ys0 = torch.ones(b, m * n, dtype=torch.float64)
    xf, _, _, res = ts.instance_batched_riptrm(
        opt, max_steps=1500, problem_builder=lambda a, x0: tl.make_problem(a, x0))(
        torch.tensor(data), xs0, ys0)
    assert float(res.max()) <= 1e-6
    jxf, _, _, jres = js.instance_batched_riptrm(
        opt, max_steps=1500, problem_builder=lambda a, x0: jl.make_problem(a, x0))(
        jnp.asarray(data), tuple(jnp.asarray(c.numpy()) for c in comps), jnp.asarray(ys0))
    assert float(np.max(np.asarray(jres))) <= 1e-6
    # the matrices X = U S V' agree (the factors are determined up to sign)
    for i in range(b):
        u, s, v = (a[i].numpy() for a in man.unpack(xf))
        ju, jsv, jv = (np.asarray(a[i]) for a in jxf)
        np.testing.assert_allclose((u * s) @ v.T, (ju * jsv) @ jv.T, atol=1e-5)


class _Calls:
    """Counts the calls of a kernel wrapper and the lanes of each."""

    def __init__(self, fn, lanes_of):
        self.fn, self.lanes_of, self.lanes = fn, lanes_of, []

    def __call__(self, *args, **kw):
        self.lanes.append(self.lanes_of(*args))
        return self.fn(*args, **kw)


def test_per_lane_zs_routes_to_one_lane_kernels(monkeypatch):
    """``use_fused_tcg`` with a per-lane Zs: the route is K2 once a lane on
    the sphere and the Stiefel kernel once a lane at B = 1 on St(n, p), never
    K3 or a multi-lane Stiefel launch; each lane's step equals that
    instance's own one-lane fused step."""
    fused = OPTION | {"use_fused_tcg": True}
    zs, xs, ys = instances(3, 12, seed=1)
    p = tn.make_problem(torch.tensor(zs), torch.tensor(xs), device="cpu")
    assert p.data.shape == (3, 12, 12) and p.structure["Zs"].shape == (3, 12, 12)
    opt = trm.RIPTRM(fused).option
    st0 = ts.init_state_from(p, opt, torch.tensor(xs), torch.tensor(ys))
    c0 = p.slack(st0.x)
    assert p.fused_tcg_at(st0.x, st0.y, c0) is not None
    shared = tn.make_problem(zs[0], xs[0], device="cpu")
    k3 = _Calls(tk.fused_tcg_sphere_quadratic_batched, lambda zs, x, *a: (zs.shape, x.shape))
    monkeypatch.setattr(tk, "fused_tcg_sphere_quadratic_batched", k3)
    cx = trm._barrier_ops(shared, st0.x, st0.y, st0.mu)[2]
    shared.fused_tcg_at(st0.x, st0.y, c0)(cx, st0.tr_radius, maxinner=11)
    assert k3.lanes == [((12, 12), (3, 12))]  # one Zs for the lanes: K3 once
    wide = dataclasses.replace(p, manifold=tn.Sphere(7233), structure={
        "kind": "sphere_quadratic", "Zs": torch.zeros(()).expand(3, 7233, 7233)})
    assert wide.fused_tcg_at(torch.zeros(3, 7233), st0.y, c0) is None

    monkeypatch.setattr(tk, "fused_tcg_sphere_quadratic_batched",
                        lambda *a, **k: pytest.fail("K3 called with a per-lane Zs"))
    k2 = _Calls(tk.fused_tcg_sphere_quadratic, lambda zs, x, *a: (zs.shape, x.shape))
    monkeypatch.setattr(tk, "fused_tcg_sphere_quadratic", k2)
    new, _ = trm.make_step(p, opt)(st0)
    assert k2.lanes == [((12, 12), (12,))] * 3
    for i in range(3):
        pi = tn.make_problem(zs[i], xs[i], device="cpu")
        one, _ = trm.make_step(pi, opt)(trm.init_state(pi, opt))
        np.testing.assert_allclose(new.x[i].numpy(), one.x[0].numpy(), rtol=1e-10,
                                   atol=1e-12)

    # BoundedPCA: the Stiefel kernel once a lane at B = 1
    gen = torch.Generator().manual_seed(2)
    n, pp, b = 10, 2, 3
    bz = np.stack([z[:n, :n] for z in zs])
    frames = torch.stack([tb.generate_initialpoint(gen, n, pp, bound=0.8, margin=0.05,
                                                   dtype=torch.float64, device="cpu")
                          for _ in range(b)])
    bp = tb.make_problem(torch.tensor(bz), frames, device="cpu")
    stiefel = _Calls(tk.fused_tcg_stiefel_bound_batched, lambda zs, d, x, *a: x.shape[0])
    monkeypatch.setattr(tk, "fused_tcg_stiefel_bound_batched", stiefel)
    opt = trm.RIPTRM(fused).option
    st0 = ts.init_state_from(bp, opt, frames, torch.ones(b, bp.num_ineq, dtype=torch.float64))
    assert bp.fused_tcg_at(st0.x, st0.y, bp.slack(st0.x)) is not None
    new, _ = trm.make_step(bp, opt)(st0)
    assert stiefel.lanes == [1] * b
    for i in range(b):
        pi = tb.make_problem(bz[i], frames[i], device="cpu")
        one, _ = trm.make_step(pi, opt)(trm.init_state(pi, opt))
        np.testing.assert_allclose(new.x[i].numpy(), one.x[0].numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_exact_mode_per_lane_structure():
    """Exact mode on per-lane Zs: the Householder materialisation of each
    lane uses its own Zs, so a step equals each instance's own step."""
    zs, xs, ys = instances(2, 10, seed=4)
    opt = trm.RIPTRM({"maxiter": 10, "TRS_solver": "Exact_RepMat"}).option
    p = tn.make_problem(torch.tensor(zs), torch.tensor(xs), device="cpu")
    st0 = ts.init_state_from(p, opt, torch.tensor(xs), torch.tensor(ys))
    new, info = trm.make_step(p, opt)(st0)
    for i in range(2):
        pi = tn.make_problem(zs[i], xs[i], device="cpu")
        one, one_info = trm.make_step(pi, opt)(trm.init_state(pi, opt))
        np.testing.assert_allclose(new.x[i].numpy(), one.x[0].numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(float(info["mineigvalHw"][i]),
                                   float(one_info["mineigvalHw"][0]), rtol=1e-8)

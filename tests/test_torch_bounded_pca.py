"""BoundedPCA on St(n, p) in the PyTorch port against ``riptrm_tpu``.

(a) every ``Problem`` operator, ``compute_residual`` and ``evaluation`` on
    the golden instance ``dataset/BoundedPCA/1`` (St(30, 3), bound 0.8), two
    lanes at once, each held to the JAX problem at that point: float64,
    rtol 1e-10 (atol 1e-13 for entries that are zero up to roundoff);
(b) one ``make_step`` from the same state in both packages, rtol 1e-9;
(c) the golden ``RIPTRM.run`` on points a and b (tCG, first order, float64):
    residual <= 1e-8 and cost -5.2090815 +- 1e-6 on the plain route and on
    the fused route (the kernel's plain version on the CPU), and the plain
    route's per-outer-iteration residuals against the JAX run;
(d) a B = 4 sweep at St(16, 2) against per-lane solves;
(e) a vmapped JAX state [B, n, p] through ``state_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops.kkt import compute_residual as t_residual
from riptrm_torch.ops.kkt import evaluation as t_evaluation
from riptrm_torch.parallel.sweep import batched_riptrm_solve, init_state_from
from riptrm_torch.problems import bounded_pca as tb
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.ops.kkt import compute_residual as j_residual
from riptrm_tpu.ops.kkt import evaluation as j_evaluation
from riptrm_tpu.parallel import sweep as j_sweep
from riptrm_tpu.problems import bounded_pca as jb
from riptrm_tpu.solvers import riptrm as jrm

torch.set_num_threads(1)

DATA = "dataset/BoundedPCA/1"
RTOL, ATOL = 1e-10, 1e-13
SLICE = {"TRS_solver": "tCG", "second_order_stationarity": False}
GOLDEN = SLICE | {"maxtime": 120, "maxiter": 40, "tolresid": 1e-8, "verbosity": 0}
GOLDEN_COST = -5.2090815


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def both():
    """Both problems at point a, and two lanes: point a and a second
    feasible frame, with multipliers, a tangent and a constraint-space
    vector per lane."""
    jp, tp = jb.load_problem(DATA, "a"), tb.load_problem(DATA, "a", device="cpu")
    n, p = jp.manifold.n, jp.manifold.p
    rng = np.random.default_rng(0)
    while True:
        q, _ = np.linalg.qr(rng.standard_normal((n, p)))
        if np.abs(q).max() < 0.7:
            break
    xs = np.stack([np.asarray(jp.x0), q])
    ys = np.stack([np.asarray(jp.y0), 0.5 + rng.random(jp.num_ineq)])
    amb = rng.standard_normal((2, n, p))
    vs = amb - xs @ (0.5 * (np.swapaxes(xs, 1, 2) @ amb + np.swapaxes(amb, 1, 2) @ xs))
    ws = rng.standard_normal((2, jp.num_ineq))
    return jp, tp, xs, ys, vs, ws


CASES = {
    "cost": lambda p, x, y, v, w: p.cost(x),
    "egrad": lambda p, x, y, v, w: p.egrad(x),
    "rgrad": lambda p, x, y, v, w: p.rgrad(x),
    "slack": lambda p, x, y, v, w: p.slack(x),
    "ineq_val": lambda p, x, y, v, w: p.ineq_val(x),
    "manvio": lambda p, x, y, v, w: p.manvio(x),
    "lag_rgrad": lambda p, x, y, v, w: p.lag_rgrad(x, y),
    "lag_rhess_at": lambda p, x, y, v, w: p.lag_rhess_at(x, y)(v),
    "gx_at": lambda p, x, y, v, w: p.gx_at(x)(w),
    "gx_adj_at": lambda p, x, y, v, w: p.gx_adj_at(x)(v),
    "gx_adj": lambda p, x, y, v, w: p.gx_adj(x, v),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_matches_jax(both, name):
    jp, tp, xs, ys, vs, ws = both
    got = CASES[name](tp, *map(_t, (xs, ys, vs, ws))).numpy()
    assert got.shape[0] == 2
    for i in range(2):
        want = np.asarray(CASES[name](jp, *(jnp.asarray(a[i]) for a in (xs, ys, vs, ws))))
        np.testing.assert_allclose(got[i], want, rtol=RTOL, atol=ATOL, err_msg=str(i))


def test_residual_and_evaluation_match_jax(both):
    jp, tp, xs, ys, _, _ = both
    got_res = t_residual(tp, _t(xs), _t(ys))
    x_prev = np.stack([xs[1], xs[0]])
    got = t_evaluation(tp, _t(x_prev), _t(xs), _t(ys))
    zero = jnp.zeros((0,))
    for i in range(2):
        want_res = j_residual(jp, jnp.asarray(xs[i]), jnp.asarray(ys[i]), zero)
        for g, w in zip(got_res, want_res):
            np.testing.assert_allclose(g[i].item(), float(w), rtol=RTOL, atol=ATOL)
        want = j_evaluation(jp, jnp.asarray(x_prev[i]), jnp.asarray(xs[i]),
                            jnp.asarray(ys[i]), zero)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k][i].item(), float(want[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def test_problem_data_and_structure(both):
    jp, tp, *_ = both
    assert tp.manifold.n == jp.manifold.n == 30 and tp.manifold.p == jp.manifold.p == 3
    assert tp.num_ineq == jp.num_ineq == 2 * 30 * 3 and tp.num_eq == jp.num_eq == 0
    assert tp.structure["kind"] == jp.structure["kind"] == "stiefel_bound"
    for key in ("Zs", "bound", "d"):
        np.testing.assert_array_equal(tp.structure[key].numpy(),
                                      np.asarray(jp.structure[key]), err_msg=key)
    np.testing.assert_array_equal(tp.x0.numpy(), np.asarray(jp.x0))
    np.testing.assert_array_equal(tp.y0.numpy(), np.asarray(jp.y0))
    # custom weights and the default y0 = 1
    z = tp.structure["Zs"].numpy()
    tw = tb.make_problem(z, tp.x0.numpy(), weights=[3.0, 2.0, 1.0], device="cpu")
    jw = jb.make_problem(z, np.asarray(jp.x0), weights=[3.0, 2.0, 1.0])
    np.testing.assert_array_equal(tw.structure["d"].numpy(), np.asarray(jw.structure["d"]))
    np.testing.assert_array_equal(tw.y0.numpy(), np.asarray(jw.y0))


def test_generators():
    """The JAX generators' construction and refusals (the draws differ)."""
    g = torch.Generator().manual_seed(0)
    z = tb.generate_instance(g, 24, device="cpu")["Z"]
    assert z.shape == (24, 24) and z.dtype == torch.float64
    x0 = tb.generate_initialpoint(g, 24, 3, bound=0.6, device="cpu")
    np.testing.assert_allclose((x0.T @ x0).numpy(), np.eye(3), atol=1e-12)
    assert float(torch.abs(x0).max()) <= 0.6 - 0.05
    with pytest.raises(ValueError, match="no orthonormal frame"):
        tb.generate_initialpoint(g, 16, 2, bound=0.3, device="cpu")
    with pytest.raises(ValueError, match="no feasible start"):
        tb.generate_initialpoint(g, 16, 2, bound=0.33, margin=0.0, max_draws=3,
                                   device="cpu")


# ---------------------------------------------------------------------------
# (b) one step from the same state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start", [0, 12], ids=["init", "step12"])
def test_make_step_matches_jax(both, start):
    """Every info field and the new state to rtol 1e-9.  Later in the run
    the step's ared (a difference of two costs of size ~5.2 that agree to
    ~1e-10) and the Lagrangian gradient near the optimum cancel, and one
    step from the same state differs by up to ~1e-3 (relative) in those
    fields between the packages from roundoff alone; the whole run is
    held per outer iteration in (c)."""
    jp, tp, *_ = both
    jopt = jrm.RIPTRM(GOLDEN).option
    jstep = jax.jit(jrm.make_step(jp, jopt))
    st = jrm.init_state(jp, jopt)
    for _ in range(start):
        st, _ = jstep(st)
    d = jax.device_get(st)._asdict()
    j_new, j_info = jstep(st)
    j_new, j_info = jax.device_get(j_new)._asdict(), jax.device_get(j_info)

    t_state = trm.state_from_numpy(d, device="cpu")  # an unbatched [n, p] state: one lane
    assert t_state.x.shape == (1, 30, 3) and t_state.y.shape == (1, 180)
    t_new, t_info = trm.make_step(tp, trm.RIPTRM(GOLDEN).option)(t_state)
    assert set(t_info) == set(j_info)
    for k, v in j_info.items():
        np.testing.assert_allclose(t_info[k][0].item(), np.asarray(v, float), rtol=1e-9,
                                   atol=1e-15, equal_nan=True, err_msg=k)
    t_new = trm.state_to_numpy(t_new)
    for k, v in j_new.items():
        assert t_new[k].shape == np.shape(v), k
        np.testing.assert_allclose(t_new[k], np.asarray(v), rtol=1e-9, atol=1e-15,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (c) the golden run
# ---------------------------------------------------------------------------
def _outer_rows(log):
    return [
        (it, s, r)
        for it, s, r in zip(log["iteration"], log["inner_status"], log["residual"])
        if s in ("converged", "max-iter-exceeded")
    ]


@pytest.mark.parametrize("point", ["a", "b"])
def test_golden_run_tracks_jax(point):
    """Plain route: the JAX run's outer iterations with the same statuses,
    and the same residual at each to rtol 1e-6 while it is above 1e-6.
    Below that the trajectory is roundoff-sensitive, as on NonnegPCA
    (ROADMAP.md queue 3), so those rows are held to rtol 1e-2."""
    jp, tp = jb.load_problem(DATA, point), tb.load_problem(DATA, point, device="cpu")
    j_out, t_out = jrm.RIPTRM(GOLDEN).run(jp), trm.RIPTRM(GOLDEN).run(tp)
    assert t_out.log["residual"][-1] <= 1e-8
    assert t_out.log["cost"][-1] == pytest.approx(GOLDEN_COST, abs=1e-6)
    x = t_out.x.numpy()
    np.testing.assert_allclose(x.T @ x, np.eye(3), atol=1e-12)  # on St(30, 3)
    assert np.abs(x).max() < 0.8 and t_out.ineqLagmult.numpy().min() > 0
    j_rows, t_rows = _outer_rows(j_out.log), _outer_rows(t_out.log)
    assert [r[:2] for r in t_rows] == [r[:2] for r in j_rows]
    j_res = np.array([r[2] for r in j_rows])
    t_res = np.array([r[2] for r in t_rows])
    tight = j_res > 1e-6
    assert tight.sum() >= 5
    np.testing.assert_allclose(t_res[tight], j_res[tight], rtol=1e-6)
    np.testing.assert_allclose(t_res[~tight], j_res[~tight], rtol=1e-2)
    assert set(t_out.log) == set(j_out.log)


@pytest.mark.parametrize("point", ["a", "b"])
def test_golden_run_fused_route(point):
    """``use_fused_tcg``: the Stiefel-bound kernel's plain version (float32
    tCG inside the float64 solve) reaches the same solution."""
    tp = tb.load_problem(DATA, point, device="cpu")
    out = trm.RIPTRM(GOLDEN | {"use_fused_tcg": True}).run(tp)
    assert out.log["residual"][-1] <= 1e-8
    assert out.log["cost"][-1] == pytest.approx(GOLDEN_COST, abs=1e-6)


# ---------------------------------------------------------------------------
# (d) a batched sweep against per-lane solves
# ---------------------------------------------------------------------------
def test_batched_sweep_matches_per_lane_solves():
    """B = 4 at St(16, 2) (``tests/test_bounded_pca.py``'s sweep: the JAX
    instance and starts, bound 0.6): equal steps, x to rtol 1e-6, every lane
    at residual <= 1e-7 and on St(16, 2)."""
    n, p, bound, b = 16, 2, 0.6, 4
    z = np.asarray(jb.generate_instance(jax.random.PRNGKey(5), n, snr=2.0)["Z"])
    xs = np.stack([
        jb.generate_initialpoint(jax.random.PRNGKey(20 + i), n, p, bound=bound)
        for i in range(b)
    ])
    ys = np.ones((b, 2 * n * p))
    tp = tb.make_problem(z, xs[0], bound=bound, device="cpu")
    opt = SLICE | {"maxiter": 40, "tolresid": 1e-7}
    state, steps, res = batched_riptrm_solve(tp, opt, 800)(_t(xs), _t(ys))
    assert steps.shape == (b,) and res.shape == (b,) and state.x.shape == (b, n, p)
    assert float(res.max()) <= 1e-7
    solver = trm.RIPTRM(opt)
    solve = solver.solve_compiled(tp, 800)
    for i in range(b):
        st_i, k_i = solve(init_state_from(tp, solver.option, _t(xs[i]), _t(ys[i])))
        assert int(k_i[0]) == int(steps[i]), i
        np.testing.assert_allclose(state.x[i].numpy(), st_i.x[0].numpy(), rtol=1e-6,
                                   atol=1e-12)
        x = state.x[i].numpy()
        np.testing.assert_allclose(x.T @ x, np.eye(p), atol=1e-8)


# ---------------------------------------------------------------------------
# (e) a vmapped JAX state through state_from_numpy
# ---------------------------------------------------------------------------
def test_vmapped_jax_state_round_trip(both):
    jp, _, xs, ys, _, _ = both
    opt = jrm.RIPTRM(GOLDEN).option
    init = jax.vmap(lambda x, y: j_sweep.init_state_from(jp, opt, x, y))
    j_state = jax.device_get(init(jnp.asarray(xs), jnp.asarray(ys)))._asdict()
    assert np.shape(j_state["x"]) == (2, 30, 3)
    t_state = trm.state_from_numpy(j_state, device="cpu")
    assert t_state.lanes == 2 and t_state.x.shape == (2, 30, 3)
    assert t_state.y.shape == (2, 180) and t_state.mu.shape == (2,)
    back = trm.state_to_numpy(t_state)
    for k, v in j_state.items():
        assert back[k].shape == np.shape(v), k
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    # and the port's own init_state_from gives the same state
    own = trm.state_to_numpy(init_state_from(jp_to_t(jp), trm.RIPTRM(GOLDEN).option,
                                             _t(xs), _t(ys)))
    for k, v in j_state.items():
        np.testing.assert_array_equal(own[k], np.asarray(v), err_msg=k)


def jp_to_t(jp):
    return tb.make_problem(np.asarray(jp.structure["Zs"]), np.asarray(jp.x0),
                           np.asarray(jp.y0), device="cpu")

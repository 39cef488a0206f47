"""RIPTRM (tCG, first order) of the PyTorch port against ``riptrm_tpu`` on
the golden instance ``dataset/NonnegPCA/1``, point a (n = 50), float64.

(a) one ``make_step`` from the same state in both packages: every info
    field and the new state, rtol 1e-9;
(b)-(c) the ``tests/test_solvers.py`` analogues of ``test_tcg_converges``
    and ``test_barrier_schedule``;
(d) the per-outer-iteration log of ``run`` against the JAX run;
(e) ``solve_compiled`` against ``run`` (``test_compiled_matches_host``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops.kkt import compute_residual as t_residual
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import riptrm as jrm

torch.set_num_threads(1)

DATA = "dataset/NonnegPCA/1"
OPT_COMMON = {"maxtime": 120, "maxiter": 30, "verbosity": 0}
SLICE = {"TRS_solver": "tCG", "second_order_stationarity": False}
GOLDEN = OPT_COMMON | SLICE | {"tolresid": 1e-8}


@pytest.fixture(scope="module")
def problems():
    return jn.load_problem(DATA, "a"), tn.load_problem(DATA, "a", device="cpu")


@pytest.fixture(scope="module")
def runs(problems):
    jp, tp = problems
    return jrm.RIPTRM(GOLDEN).run(jp), trm.RIPTRM(GOLDEN).run(tp)


# ---------------------------------------------------------------------------
# (a) one step from the same state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start", [0, 20], ids=["init", "step20"])
def test_make_step_matches_jax(problems, start):
    jp, tp = problems
    jopt = jrm.RIPTRM(GOLDEN).option
    jstep = jax.jit(jrm.make_step(jp, jopt))
    st = jrm.init_state(jp, jopt)
    for _ in range(start):  # walk the JAX trajectory to a mid-solve state
        st, _ = jstep(st)
    d = jax.device_get(st)._asdict()
    j_new, j_info = jstep(st)
    j_new, j_info = jax.device_get(j_new)._asdict(), jax.device_get(j_info)

    t_state = trm.state_from_numpy(d, device="cpu")
    np.testing.assert_array_equal(trm.state_to_numpy(t_state)["x"], d["x"])
    t_new, t_info = trm.make_step(tp, trm.RIPTRM(GOLDEN).option)(t_state)

    assert set(t_info) == set(j_info)
    for k, v in j_info.items():
        got = t_info[k][0].item()
        np.testing.assert_allclose(got, np.asarray(v, float), rtol=1e-9, atol=1e-15,
                                   equal_nan=True, err_msg=k)
    t_new = trm.state_to_numpy(t_new)
    assert set(t_new) == set(j_new)
    for k, v in j_new.items():
        assert t_new[k].shape == np.shape(v), k
        np.testing.assert_allclose(t_new[k], np.asarray(v), rtol=1e-9, atol=1e-15,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (b) golden convergence, (c) barrier schedule
# ---------------------------------------------------------------------------
def test_tcg_converges(runs):
    _, out = runs
    assert out.log["residual"][-1] <= 1e-8
    x = out.x.numpy()
    assert abs(np.linalg.norm(x) - 1) < 1e-12  # on-sphere
    assert x.min() > -1e-12  # feasible
    assert out.ineqLagmult.numpy().min() > 0  # dual feasible
    assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)


def test_barrier_schedule(problems):
    _, tp = problems
    out = trm.RIPTRM(OPT_COMMON | SLICE | {"maxiter": 4, "tolresid": 0}).run(tp)
    mus = sorted(set(out.log["mu"][1:]), reverse=True)
    # mu follows max(1e-15, 0.5 * mu^1.01) from 0.1
    expected = [0.1]
    for _ in range(3):
        expected.append(max(1e-15, 0.5 * expected[-1] ** 1.01))
    np.testing.assert_allclose(mus[: len(expected)], expected, rtol=1e-12)


# ---------------------------------------------------------------------------
# (d) per-outer-iteration log against the JAX run
# ---------------------------------------------------------------------------
def _outer_rows(log):
    """(outer iteration, status, residual) of the rows that close an outer
    iteration (inner status converged or max-iter), in order."""
    return [
        (it, s, r)
        for it, s, r in zip(log["iteration"], log["inner_status"], log["residual"])
        if s in ("converged", "max-iter-exceeded")
    ]


def test_run_tracks_jax_per_outer_iteration(runs):
    """Same outer iterations with the same statuses, and the same residual
    at each.  rtol 1e-6 while the residual is above 1e-6 (outer iterations
    1-18 here).  Below that the reference itself is chaotic: perturbing x0
    by 1e-15 (relative) moves its own per-outer residuals by up to 4e-3
    (relative) in outer iterations 19-24, through the tCG's
    maximum-iteration solves on the ill-conditioned barrier operator, so
    those rows are held to 1e-2."""
    j_out, t_out = runs
    j_rows, t_rows = _outer_rows(j_out.log), _outer_rows(t_out.log)
    assert [r[:2] for r in t_rows] == [r[:2] for r in j_rows]
    j_res = np.array([r[2] for r in j_rows])
    t_res = np.array([r[2] for r in t_rows])
    tight = j_res > 1e-6
    assert tight.sum() >= 18
    np.testing.assert_allclose(t_res[tight], j_res[tight], rtol=1e-6)
    np.testing.assert_allclose(t_res[~tight], j_res[~tight], rtol=1e-2)
    assert t_res[-1] <= 1e-8 and j_res[-1] <= 1e-8
    # every inner row up to the end of outer iteration 18 takes the same
    # branch and tCG stop as well
    n18 = t_out.log["iteration"].index(19)
    assert t_out.log["inner_status"][:n18] == j_out.log["inner_status"][:n18]
    assert t_out.log["dxtype"][:n18] == j_out.log["dxtype"][:n18]
    assert set(t_out.log) == set(j_out.log)


# ---------------------------------------------------------------------------
# (e) fixed-budget solve against the host runner
# ---------------------------------------------------------------------------
def test_compiled_matches_host(problems):
    _, tp = problems
    opt = OPT_COMMON | SLICE | {"maxiter": 40, "tolresid": 1e-9}
    solver = trm.RIPTRM(opt)
    state, k = solver.solve_compiled(tp, max_steps=600)(trm.init_state(tp, solver.option))
    res = float(t_residual(tp, state.x, state.y)[0][0])
    assert res <= 1e-9
    host = solver.run(tp)
    assert host.log["residual"][-1] <= 1e-9
    assert 0 < int(k[0]) <= 600


def test_solve_compiled_best_stops_at_target(problems):
    """A lane stops once its best inner-converged residual reaches the
    target, and ``best`` is that residual."""
    _, tp = problems
    solver = trm.RIPTRM(OPT_COMMON | SLICE | {"tolresid": 1e-9})
    st0 = trm.init_state(tp, solver.option)
    _, k_full = solver.solve_compiled(tp, max_steps=600)(st0)
    st, k, best = solver.solve_compiled_best(tp, max_steps=600)(st0, 1e-3)
    assert 0 < int(k[0]) < int(k_full[0])
    assert float(best[0]) <= 1e-3
    # the stop came at an outer transition whose residual is the best
    assert float(best[0]) == pytest.approx(float(t_residual(tp, st.x, st.y)[0][0]),
                                           rel=1e-12)
    # a target at or above the starting residual stops before any step
    _, k0, best0 = solver.solve_compiled_best(tp, max_steps=600)(st0, 1e3)
    assert int(k0[0]) == 0 and float(best0[0]) > 1e-3


def test_force_outer_matches_jax(problems):
    """The ``inner_maxtime`` reset against JAX's ``make_force_outer``."""
    jp, tp = problems
    jopt = jrm.RIPTRM(GOLDEN).option
    jstep = jax.jit(jrm.make_step(jp, jopt))
    st = jrm.init_state(jp, jopt)
    for _ in range(3):
        st, _ = jstep(st)
    want = jax.device_get(jrm.make_force_outer(jopt)(st))._asdict()
    got = trm.state_to_numpy(
        trm.make_force_outer(trm.RIPTRM(GOLDEN).option)(
            trm.state_from_numpy(jax.device_get(st)._asdict(), device="cpu")
        )
    )
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-12, err_msg=k)


def test_fused_tcg_option_solves_on_cpu(problems):
    """``use_fused_tcg`` on a CPU problem runs the kernels' plain versions
    (float32 tCG inside a float64 solve) and still converges."""
    _, tp = problems
    out = trm.RIPTRM(GOLDEN | {"use_fused_tcg": True}).run(tp)
    assert out.log["residual"][-1] <= 1e-8
    assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)


@pytest.mark.parametrize("key", ["checkpoint_path", "wandb_logging"])
def test_options_outside_the_slice_raise(problems, key, tmp_path):
    """``checkpoint_path`` and ``wandb_logging`` were refused until the
    experiment layer was ported; now a run with ``checkpoint_path`` writes
    its checkpoint (state, elapsed budget and log), and ``wandb_logging``
    without wandb installed warns and turns itself off."""
    _, tp = problems
    opt = SLICE | {"maxiter": 2}
    if key == "checkpoint_path":
        path = tmp_path / "ckpt.npz"
        out = trm.RIPTRM(opt | {key: str(path), "checkpoint_every": 0.0}).run(tp)
        with np.load(path) as data:
            assert "leaf.x" in data and "leaf.h_lam" in data
            meta = json.loads(str(data["__meta__"]))
        assert meta["log"]["residual"] == out.log["residual"]
    else:
        solver = trm.RIPTRM(opt | {key: True})
        with pytest.warns(UserWarning, match="wandb is not installed"):
            solver.run(tp)
        assert solver.option[key] is False


@pytest.mark.parametrize(
    "option",
    [
        {},  # the JAX defaults: exact mode, second order
        {"second_order_stationarity": False},
        {"TRS_solver": "tCG"},
        SLICE | {"checkTRSoptimality": True},
        SLICE | {"compensated_reductions": True},
    ],
)
def test_exact_and_second_order_options_are_in_the_slice(option):
    """Exact mode, the second-order criterion, the TRS self-check and the
    compensated reductions are ported: ``check_slice`` takes them."""
    trm.check_slice(trm.RIPTRM(option).option)

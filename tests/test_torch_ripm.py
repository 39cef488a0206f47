"""RIPM in the PyTorch port against ``riptrm_tpu``, float64 on the CPU.

(a) one ``make_step`` from the same state in both packages, the new state
    and every info field, rtol 1e-9 (the Newton-system errors of
    ``checkNTequation`` are rounding noise and are held below 1e-10
    instead, and CR's final relative residual to its tolerance): dense, matrix-free CR (``KrylovIterMethod``), CR with
    ``KrylovPreconditioner='jacobi_theta'`` (on NonnegPCA; the JAX tests
    run it on StableIdentification, which is not ported), and the dense
    and CR saddle systems with an equality constraint;
(b) the golden criteria of ``tests/test_solvers.py`` (``TestRIPM``) on
    ``dataset/NonnegPCA/1`` point a, with the dense run's per-iteration
    residuals held to the JAX run's to rtol 1e-6 while above 1e-6 (CR's
    inexact solves to rtol 1e-3), and ``tests/test_eq_constraints.py``'s
    RIPM criteria on its n = 12 instance;
(c) the singular-Newton instance of ``tests/test_solvers.py``: the lane
    freezes, the run stops with the flagged row logged;
(d) ``batched_ripm_continue`` at B = 3 against the JAX function;
(e) a float32 dense sweep (``batched_solver_sweep``) on NonnegPCA at n = 12
    and at the benchmark cell's n = 50, whose Newton solves take
    ``riptrm::dense_solve`` (the kernel's plain version on the CPU), against
    the JAX sweep in float32 (``jnp.linalg.solve``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.manifolds import Euclidean as TEuclidean
from riptrm_torch.manifolds import Sphere as TSphere
from riptrm_torch.parallel import sweep as tsw
from riptrm_torch.problems import Problem as TProblem
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import ripm as tr
from riptrm_tpu.manifolds import Sphere as JSphere
from riptrm_tpu.manifolds.euclidean import Euclidean as JEuclidean
from riptrm_tpu.parallel import sweep as jsw
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.problems.problem import Problem as JProblem
from riptrm_tpu.solvers import ripm as jr

torch.set_num_threads(1)
DATA = "dataset/NonnegPCA/1"
OPT_COMMON = {"maxtime": 120, "maxiter": 30, "verbosity": 0}
NOISE = ("NTdir_error1", "NTdir_error2")


def eq_problems():
    """``tests/test_eq_constraints.py``'s instance: min -x'Zx on S^11,
    x >= 0, a'x = 0.5, in both packages."""
    n = 12
    rng = np.random.default_rng(0)
    z = rng.normal(size=(n, n))
    z = z + z.T
    a = np.abs(rng.normal(size=n))
    x0 = jnp.abs(jax.random.normal(jax.random.PRNGKey(1), (n,)))
    x0 = np.asarray(x0 / jnp.linalg.norm(x0))
    zj, aj = jnp.asarray(z), jnp.asarray(a)
    jp = JProblem(
        manifold=JSphere(n), cost=lambda x: -(x @ (zj @ x)), ineq=lambda x: -x,
        eq=lambda x: jnp.atleast_1d(aj @ x - 0.5), x0=jnp.asarray(x0), y0=jnp.ones((n,)),
        z0=jnp.zeros((1,)), num_ineq=n, num_eq=1, manvio=lambda x: jnp.linalg.norm(x) - 1.0,
    )
    zt, at = torch.tensor(z), torch.tensor(a)
    tp = TProblem(
        manifold=TSphere(n), cost_fn=lambda x: -(x @ (zt @ x)), ineq_fn=lambda x: -x,
        eq_fn=lambda x: (at @ x - 0.5).reshape(1), x0=torch.tensor(x0),
        y0=torch.ones(n, dtype=torch.float64), z0=torch.zeros(1, dtype=torch.float64),
        num_ineq=n, num_eq=1, manvio_fn=lambda x: torch.linalg.vector_norm(x) - 1.0,
    )
    return jp, tp


@pytest.fixture(scope="module")
def pca():
    return jn.load_problem(DATA, "a"), tn.load_problem(DATA, "a", device="cpu")


@pytest.fixture(scope="module")
def eq():
    return eq_problems()


def _to_torch(state):
    return tr.state_from_numpy(jax.device_get(state)._asdict(), device="cpu")


def _check_step(jp, tp, option, jstate, tau, rtol=1e-9):
    jnew, jinfo = jax.jit(jr.make_step(jp, option))(jstate, *tau)
    tnew, tinfo = tr.make_step(tp, option)(_to_torch(jstate),
                                           *(torch.tensor(float(t)).reshape(1) for t in tau))
    for k, v in tr.state_to_numpy(tnew).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jnew, k)), rtol=rtol, atol=1e-14,
                                   err_msg=k)
    assert set(tinfo) == set(jinfo)
    for k, v in jinfo.items():
        if k in NOISE:
            assert float(tinfo[k][0]) < 1e-10 and float(v) < 1e-10
        elif k == "KrylovIterMethod_RelRes":
            # a converged CR's residual lies below its tolerance, where
            # rounding decides it
            np.testing.assert_allclose(float(tinfo[k][0]), float(v), rtol=rtol,
                                       atol=option["KrylovTolrelresid"])
        else:
            np.testing.assert_allclose(tinfo[k][0].numpy(), np.asarray(v), rtol=rtol,
                                       atol=1e-14, err_msg=k)
    return jnew, jinfo


MODES = {
    "dense": {"checkNTequation": True},
    "krylov": {"KrylovIterMethod": True},
    "jacobi_theta": {"KrylovIterMethod": True, "KrylovPreconditioner": "jacobi_theta"},
}


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax(pca, mode):
    jp, tp = pca
    option = tr.RIPM(MODES[mode]).option
    jstate, t1, t2 = jr.init_state(jp, option)
    for _ in range(3):  # the first steps, and one with a backtracking line search
        jnew, info = _check_step(jp, tp, option, jstate, (t1, t2))
        jstate = jnew
    assert int(info["linesearch_counter"]) >= 0


@pytest.mark.parametrize("mode", ["dense", "krylov"])
def test_equality_step_matches_jax(eq, mode):
    jp, tp = eq
    option = tr.RIPM(MODES[mode]).option
    jstate, t1, t2 = jr.init_state(jp, option)
    for _ in range(2):
        jstate, _ = _check_step(jp, tp, option, jstate, (t1, t2))


def test_jacobi_theta_refuses_equalities(eq):
    _, tp = eq
    with pytest.raises(NotImplementedError, match="inequality-only"):
        tr.make_step(tp, tr.RIPM(MODES["jacobi_theta"]).option)


def test_wandb_is_refused(pca):
    """``wandb_logging`` is accepted since the wandb hooks were ported: wandb
    is not installed here, so the run warns and turns the option off, as the
    JAX package does."""
    solver = tr.RIPM({"wandb_logging": True, "maxiter": 2})
    with pytest.warns(UserWarning, match="wandb is not installed"):
        out = solver.run(pca[1])
    assert solver.option["wandb_logging"] is False
    assert len(out.log["residual"]) == 3


def _tracks(j_log, t_log, rtol):
    assert set(t_log) == set(j_log)
    j_res, t_res = np.array(j_log["residual"]), np.array(t_log["residual"])
    assert len(t_res) == len(j_res)
    tight = j_res > 1e-6
    np.testing.assert_allclose(t_res[tight], j_res[tight], rtol=rtol)


def test_golden_dense_with_nt_check(pca):
    jp, tp = pca
    opt = OPT_COMMON | {"tolresid": 1e-6, "checkNTequation": True}
    out = tr.RIPM(opt).run(tp)
    assert out.log["residual"][-1] <= 1e-6
    assert max(v for v in out.log["NTdir_error1"] if v is not None) < 1e-10
    assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)
    _tracks(jr.RIPM(opt).run(jp).log, out.log, 1e-6)


def test_golden_krylov(pca):
    jp, tp = pca
    opt = OPT_COMMON | {"tolresid": 1e-6, "KrylovIterMethod": True}
    out = tr.RIPM(opt).run(tp)
    assert out.log["residual"][-1] <= 1e-6
    _tracks(jr.RIPM(opt).run(jp).log, out.log, 1e-3)


def test_equality_instance(eq):
    """``tests/test_eq_constraints.py::test_ripm_handles_eq_constraints``."""
    jp, tp = eq
    opt = {"maxtime": 60, "maxiter": 10, "tolresid": 1e-7, "checkNTequation": True}
    out = tr.RIPM(opt).run(tp)
    assert max(v for v in out.log["NTdir_error1"] if v is not None) < 1e-10
    assert out.log["residual"][-1] < 0.5 * out.log["residual"][0]
    _tracks(jr.RIPM(opt).run(jp).log, out.log, 1e-6)


def test_singular_newton_exits_gracefully():
    """cost x[1]^2 with one constraint on x[1]: the condensed matrix is
    singular in coordinate 0 at every point."""
    jp = JProblem(
        manifold=JEuclidean(2), cost=lambda x: x[1] ** 2,
        ineq=lambda x: jnp.asarray([-x[1] - 1.0]), x0=jnp.asarray([0.5, 0.5]),
        y0=jnp.asarray([1.0]), z0=jnp.zeros((0,)), num_ineq=1, num_eq=0,
    )
    tp = TProblem(
        manifold=TEuclidean(2), cost_fn=lambda x: x[1] ** 2,
        ineq_fn=lambda x: (-x[1] - 1.0).reshape(1),
        x0=torch.tensor([0.5, 0.5], dtype=torch.float64),
        y0=torch.tensor([1.0], dtype=torch.float64), z0=torch.zeros(0, dtype=torch.float64),
        num_ineq=1, num_eq=0,
    )
    opt = {"maxtime": 60, "maxiter": 25, "tolresid": 1e-12}
    out = tr.RIPM(opt).run(tp)
    assert "Singular Newton" in out.option["stoppingcriterion"]
    assert torch.isfinite(out.x).all()
    assert np.all(np.isfinite(np.asarray(out.log["residual"], dtype=float)))
    assert out.log["singular_newton"][-1] is True
    j_log = jr.RIPM(opt).run(jp).log
    assert len(out.log["residual"]) == len(j_log["residual"])
    np.testing.assert_allclose(out.log["residual"], j_log["residual"], rtol=1e-12)


def test_batched_ripm_continue(eq):
    """Three lanes of prior states re-entered by the continuation, with
    phi, sigma, rho and the tau's recomputed: states, steps and residuals
    against the JAX function."""
    jp, tp = eq
    rng = np.random.default_rng(2)
    xs = np.abs(rng.standard_normal((3, 12)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    ys = 0.5 + rng.random((3, 12))
    opt = {"maxiter": 8, "tolresid": 1e-9}
    st = {"x": xs, "y": np.zeros((3, 1)), "z": ys, "s": ys, "phi": np.ones(3),
          "sigma": np.full(3, 0.5), "rho": np.ones(3), "gamma": np.full(3, 0.9),
          "iteration": np.full(3, 5)}
    j_st, j_k, j_res = jsw.batched_ripm_continue(jp, opt, 8)(
        jr.RipmState(**{k: jnp.asarray(v) for k, v in st.items()}))
    t_st, t_k, t_res = tsw.batched_ripm_continue(tp, opt, 8)(
        tr.state_from_numpy(st, device="cpu", dtype=torch.float64))
    assert t_k.tolist() == np.asarray(j_k).tolist()
    np.testing.assert_allclose(t_res.numpy(), np.asarray(j_res), rtol=1e-7)
    np.testing.assert_allclose(t_st.x.numpy(), np.asarray(j_st.x), rtol=1e-7, atol=1e-12)


def _cell_like_instance(n, lanes, seed=0):
    """The benchmark's NonnegPCA recipe (a spiked covariance with snr 0.5 on
    a support of 0.7 n coordinates) and uniform positive unit starts."""
    rng = np.random.default_rng(seed)
    size = int(0.7 * n)
    v = (rng.permutation(n) < size) / np.sqrt(size)
    noise = rng.standard_normal((n, n)) / np.sqrt(n)
    np.fill_diagonal(noise, rng.standard_normal(n) * 2.0 / np.sqrt(n))
    xs = rng.random((lanes, n))
    return np.sqrt(0.5) * np.outer(v, v) + noise, xs / np.linalg.norm(xs, axis=1, keepdims=True)


@pytest.mark.parametrize("n", [12, 50])
def test_float32_dense_sweep_matches_jax(n):
    """float32 dense RIPM from four starts, the benchmark cell's options:
    every Newton solve reaches ``riptrm::dense_solve`` (one call a lockstep
    step); steps lane by lane equal the JAX sweep's, residuals and answers
    within 1e-6 of its (16 eps32 on O(1) quantities: the two LUs round in
    another order), every residual under tolresid."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen += str(func) == "riptrm.dense_solve.default"
            return func(*args, **(kwargs or {}))

    z, xs = _cell_like_instance(n, 4)
    option = {"maxiter": 60, "tolresid": 3e-4, "sweep_stall_window": 25}
    tp = tn.make_problem(torch.tensor(z), torch.tensor(xs[0]), dtype=torch.float32,
                         device="cpu", matmul_precision="highest")
    with Ops() as ops:
        x, _, ks, res = tsw.batched_solver_sweep(tp, "RIPM", option, 60)(
            torch.tensor(xs, dtype=torch.float32), torch.ones(4, n))
    # the JAX package runs float32 with 32-bit defaults, as on its chip
    with jax.enable_x64(False):
        jp = jn.make_problem(jnp.asarray(z, dtype=jnp.float32), xs[0], dtype=jnp.float32,
                             matmul_precision="highest")
        jx, _, jks, jres = jsw.batched_solver_sweep(jp, "RIPM", option, 60)(
            jnp.asarray(xs, dtype=jnp.float32), jnp.ones((4, n), dtype=jnp.float32))
    assert res.dtype == torch.float32 and np.asarray(jres).dtype == np.float32
    assert ops.seen == int(ks.max()) > 0
    assert ks.tolist() == np.asarray(jks).tolist()
    assert np.all(res.numpy() <= option["tolresid"])
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)

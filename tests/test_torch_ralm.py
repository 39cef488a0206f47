"""RALM and its Riemannian subsolvers in the PyTorch port against
``riptrm_tpu``, float64 on the CPU.

(a) steepest descent and conjugate gradient on the Rayleigh quotient of
    ``tests/test_subsolvers.py`` (min -x'Ax on S^19): three lanes, one
    started near the optimum (it stops at gradient norm 1e-2 after 5
    iterations) and two capped at 10 iterations, each against the JAX
    subsolver on that start alone (iterations equal, point to rtol 1e-8,
    cost to rtol 1e-10; further on, steepest descent on this quotient moves by
    ~1e-5 under a 1e-15 change of the start in either package), and the
    JAX test's convergence criteria at 1e-9;
(b) RALM's first outer steps from the same state, every state field to
    rtol 1e-9, with clipped and with unbounded multipliers, steepest
    descent and CG.  Further steps are not compared: from step 4 on the
    golden instance the reference's own subsolver changes its iteration
    count under a 1e-15 change of x (29 against 30 iterations, 1e-5 in x;
    ROADMAP.md queue 3);
(c) the golden criteria of ``tests/test_solvers.py`` (``TestRALM``,
    ``tests/test_subsolvers.py``'s CG run) and
    ``tests/test_eq_constraints.py``'s RALM criteria (its first outer step
    already runs 34 or 35 subsolver iterations in JAX under a 1e-15
    change of x, so only the criteria are compared there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from riptrm_torch.manifolds import Sphere as TSphere
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import ralm as tr
from riptrm_torch.solvers import subsolvers as tss
from riptrm_tpu.manifolds import Sphere as JSphere
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import ralm as jr
from riptrm_tpu.solvers import subsolvers as jss
from test_torch_ripm import eq_problems

torch.set_num_threads(1)
DATA = "dataset/NonnegPCA/1"
OPT_COMMON = {"maxtime": 120, "maxiter": 30, "verbosity": 0}
SOLVERS = ["steepest_descent", "conjugate_gradient"]


@pytest.fixture(scope="module")
def rayleigh():
    n = 20
    rng = np.random.default_rng(0)
    a = rng.normal(size=(n, n))
    a = a + a.T
    x0 = np.stack([np.asarray(JSphere(n).random_point(jax.random.PRNGKey(k))) for k in range(3)])
    near = np.linalg.eigh(a)[1][:, -1] + 1e-3 * rng.standard_normal(n)
    return a, x0, near / np.linalg.norm(near)


@pytest.mark.parametrize("name", SOLVERS)
def test_subsolver_lanes_match_jax(rayleigh, name):
    a, x0, near = rayleigh
    x0 = np.concatenate([near[None], x0[1:]])
    n = a.shape[0]
    aj, at = jnp.asarray(a), torch.tensor(a)
    jman, tman = JSphere(n), TSphere(n)
    jcost = lambda x: -(x @ (aj @ x))
    tcost = lambda x: -(x @ (at @ x))
    kw = dict(max_iterations=10, min_gradient_norm=1e-2, min_step_size=1e-14)
    t = getattr(tss, name)(tman, vmap(tcost), lambda x: tman.egrad2rgrad(x, vmap(grad(tcost))(x)),
                           torch.tensor(x0), **kw)
    assert t.iterations.tolist() == [5, 10, 10]
    for i in range(3):
        j = getattr(jss, name)(jman, jcost, lambda x: jman.egrad2rgrad(x, jax.grad(jcost)(x)),
                               jnp.asarray(x0[i]), **kw)
        assert int(t.iterations[i]) == int(j.iterations)
        np.testing.assert_allclose(t.point[i].numpy(), np.asarray(j.point), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(float(t.cost[i]), float(j.cost), rtol=1e-10)


@pytest.mark.parametrize("name", SOLVERS)
def test_subsolver_converges_to_dominant_eigenvector(rayleigh, name):
    """``tests/test_subsolvers.py::test_converges_to_dominant_eigenvector``."""
    a, x0, _ = rayleigh
    at = torch.tensor(a)
    man = TSphere(a.shape[0])
    w, v = np.linalg.eigh(a)
    res = getattr(tss, name)(
        man, lambda x: -torch.sum(x * (x @ at), dim=-1),
        lambda x: man.egrad2rgrad(x, -2.0 * (x @ at)), torch.tensor(x0[:1]),
        max_iterations=500, min_gradient_norm=1e-9, min_step_size=1e-14,
    )
    assert float(res.gradient_norm[0]) < 1e-5
    assert float(res.cost[0]) == pytest.approx(-w[-1], rel=1e-10)
    assert abs(abs(float(res.point[0].numpy() @ v[:, -1])) - 1.0) < 1e-6


@pytest.fixture(scope="module")
def pca():
    return jn.load_problem(DATA, "a"), tn.load_problem(DATA, "a", device="cpu")


@pytest.mark.parametrize("extra", [
    {}, {"LagmultUnbdUpdate": True}, {"innersubsolver": "ConjugateGradient"},
    {"tolgradnorm_decay_fix": True},
], ids=["clipped", "unbounded", "cg", "decay_fix"])
def test_first_steps_match_jax(pca, extra):
    jp, tp = pca
    option = tr.RALM(extra).option
    jstep, tstep = jax.jit(jr.make_step(jp, option)), tr.make_step(tp, option)
    jstate = jr.init_state(jp, option)
    for _ in range(3):
        jnew, jinfo = jstep(jstate)
        tnew, tinfo = tstep(tr.state_from_numpy(jax.device_get(jstate)._asdict(), device="cpu"))
        for k, v in tr.state_to_numpy(tnew).items():
            np.testing.assert_allclose(v, np.asarray(getattr(jnew, k)), rtol=1e-9, atol=1e-13,
                                       err_msg=k)
        assert int(tinfo["inner_iterations"][0]) == int(jinfo["inner_iterations"])
        jstate = jnew
    y_eval, _ = tr.eval_multipliers(tp, tnew, option)
    assert torch.equal(y_eval, tnew.y_unbd if extra.get("LagmultUnbdUpdate") else tnew.y)


def test_golden_reaches_stationarity(pca):
    out = tr.RALM(OPT_COMMON | {"maxiter": 15, "tolresid": 1e-4}).run(pca[1])
    assert min(out.log["residual"]) <= 1e-3
    assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-3)
    assert set(out.log) == set(jr.RALM(OPT_COMMON | {"maxiter": 1}).run(pca[0]).log)


def test_golden_unbounded_multipliers(pca):
    out = tr.RALM(OPT_COMMON | {"maxiter": 8, "tolresid": 1e-4,
                                "LagmultUnbdUpdate": True}).run(pca[1])
    assert np.isfinite(out.log["residual"][-1])


def test_golden_cg_subsolver(pca):
    """``tests/test_subsolvers.py::test_ralm_with_cg_subsolver``."""
    out = tr.RALM({"maxtime": 60, "maxiter": 10, "tolresid": 1e-4,
                   "innersubsolver": "ConjugateGradient"}).run(pca[1])
    assert out.name == "RALM_ConjugateGradient"
    assert min(out.log["residual"]) < 1e-2


def test_equality_instance():
    """``tests/test_eq_constraints.py::test_ralm_improves_eq_constrained``."""
    jp, tp = eq_problems()
    out = tr.RALM({"maxtime": 60, "maxiter": 20, "tolresid": 1e-5}).run(tp)
    assert min(out.log["residual"]) < 0.3 * out.log["residual"][0]
    assert abs(float(tp.eq_fn(out.x)[0])) < 1e-2
    j_log = jr.RALM({"maxtime": 60, "maxiter": 0, "tolresid": 1e-5}).run(jp).log
    np.testing.assert_allclose(out.log["residual"][0], j_log["residual"][0], rtol=1e-12)


def test_unknown_subsolver_raises(pca):
    with pytest.raises(ValueError, match="innersubsolver"):
        tr.make_step(pca[1], tr.RALM({"innersubsolver": "CG"}).option)

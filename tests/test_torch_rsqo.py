"""RSQO in the PyTorch port against ``riptrm_tpu``, float64 on the CPU.

(a) one ``make_step`` from the same state in both packages for every
    ``quadoptim_type`` ('reghess', 'reghess_operator', 'reghess_shift',
    'eye') and the Newton-Schulz QP, the new state and every info field
    to rtol 1e-9, on ``dataset/NonnegPCA/1`` (the structured-sphere path)
    and with an equality constraint (the generic path);
(b) the structured-sphere step (Householder congruence, G = -B') against
    the generic one on the same problem without its structure, rtol 1e-8
    (the QP's residual norms, below its tolerance, to that tolerance);
(c) the golden criteria of ``tests/test_solvers.py`` (``TestRSQO``, chol
    and schulz), each run's per-iteration residuals held to JAX's to rtol
    1e-6 while above 1e-6, and ``tests/test_eq_constraints.py``'s RSQO
    criteria.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import rsqo as tr
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import rsqo as jr
from test_torch_ripm import eq_problems

torch.set_num_threads(1)
DATA = "dataset/NonnegPCA/1"
OPT_COMMON = {"maxtime": 120, "maxiter": 30, "verbosity": 0}
QP_NOISE = ("quadoptim_gap", "quadoptim_primalinfeasibility", "quadoptim_dualinfeasibility")
MODES = {
    "reghess": {},
    "reghess_operator": {"quadoptim_type": "reghess_operator"},
    "reghess_shift": {"quadoptim_type": "reghess_shift"},
    "eye": {"quadoptim_type": "eye"},
    "schulz": {"quadoptim_linear_solver": "schulz"},
}


@pytest.fixture(scope="module")
def pca():
    return jn.load_problem(DATA, "a"), tn.load_problem(DATA, "a", device="cpu")


def _to_torch(state):
    return tr.state_from_numpy(jax.device_get(state)._asdict(), device="cpu")


def _compare(tnew, tinfo, jnew, jinfo, rtol):
    for k, v in tr.state_to_numpy(tnew).items():
        jv = getattr(jnew, k)
        if jv is None:
            assert v is None
            continue
        np.testing.assert_allclose(v, np.asarray(jv), rtol=rtol, atol=1e-13, err_msg=k)
    assert set(tinfo) == set(jinfo)
    for k, v in jinfo.items():
        # a converged QP's residual norms lie below its tolerances, where
        # rounding decides them
        atol = 1e-8 if k in QP_NOISE else 1e-13
        np.testing.assert_allclose(tinfo[k][0].numpy(), np.asarray(v), rtol=rtol, atol=atol,
                                   err_msg=k)


def _steps(jp, tp, mode, n_steps):
    option = tr.RSQO(OPT_COMMON | {"quadoptim_eigvalcorr": 1e-2} | MODES[mode]).option
    jstep, tstep = jax.jit(jr.make_step(jp, option)), tr.make_step(tp, option)
    jstate = jr.init_state(jp, option)
    for _ in range(n_steps):
        jnew, jinfo = jstep(jstate)
        tnew, tinfo = tstep(_to_torch(jstate))
        _compare(tnew, tinfo, jnew, jinfo, 1e-9)
        jstate = jnew


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax(pca, mode):
    _steps(*pca, mode, 3)


@pytest.mark.parametrize("mode", ["reghess", "reghess_shift", "eye"])
def test_equality_step_matches_jax(mode):
    _steps(*eq_problems(), mode, 2)


@pytest.mark.parametrize("mode", ["reghess", "reghess_shift"])
def test_structured_sphere_matches_generic(pca, mode):
    _, tp = pca
    generic = dataclasses.replace(tp, structure=None)
    option = tr.RSQO(MODES[mode]).option
    state = tr.init_state(tp, option)
    for _ in range(2):
        s_new, s_info = tr.make_step(tp, option)(state)
        g_new, g_info = tr.make_step(generic, option)(state)
        g = tr.state_to_numpy(g_new)
        for k, v in tr.state_to_numpy(s_new).items():
            if v is not None:
                np.testing.assert_allclose(v, g[k], rtol=1e-8, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(float(s_info["df0"]), float(g_info["df0"]), rtol=1e-8)
        state = s_new


@pytest.mark.parametrize("key,value", [("quadoptim_type", "clamp"),
                                       ("quadoptim_linear_solver", "cholesky")])
def test_unknown_option_raises(pca, key, value):
    with pytest.raises(ValueError, match=key):
        tr.make_step(pca[1], tr.RSQO({key: value}).option)


def _tracks(j_log, t_log):
    assert set(t_log) == set(j_log)
    j_res, t_res = np.array(j_log["residual"]), np.array(t_log["residual"])
    assert len(t_res) == len(j_res)
    tight = j_res > 1e-6
    np.testing.assert_allclose(t_res[tight], j_res[tight], rtol=1e-6)
    assert t_log["quadoptim_iter"] == j_log["quadoptim_iter"]


@pytest.mark.parametrize("solver", ["chol", "schulz"])
def test_golden(pca, solver):
    jp, tp = pca
    opt = OPT_COMMON | {"tolresid": 1e-8, "quadoptim_eigvalcorr": 1e-2,
                        "quadoptim_linear_solver": solver}
    out = tr.RSQO(opt).run(tp)
    assert out.log["residual"][-1] <= 1e-8
    assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)
    _tracks(jr.RSQO(opt).run(jp).log, out.log)


def test_equality_instance():
    """``tests/test_eq_constraints.py::test_rsqo_solves_eq_constrained``."""
    jp, tp = eq_problems()
    opt = {"maxtime": 60, "maxiter": 40, "tolresid": 1e-8, "quadoptim_eigvalcorr": 1e-2}
    out = tr.RSQO(opt).run(tp)
    assert out.log["residual"][-1] < 1e-7
    x = out.x.numpy()
    assert abs(float(tp.eq_fn(out.x)[0])) < 1e-7
    assert x.min() > -1e-8 and abs(np.linalg.norm(x) - 1) < 1e-10
    _tracks(jr.RSQO(opt).run(jp).log, out.log)

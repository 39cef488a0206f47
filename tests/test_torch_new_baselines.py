"""RIPM, RSQO and RALM on StableIdentification, Rosenbrock and LowRank: the
PyTorch port against ``riptrm_tpu``, float64 on the CPU (RIPM's
``jacobi_theta`` on StableIdentification: ``tests/test_torch_new_precon.py``).

(a) One step of RIPM (dense), RSQO and RALM on StableIdentification and
    Rosenbrock from the JAX state, carried across: the new state against
    the JAX step's, rtol 1e-8 (RSQO on Rosenbrock 1e-5: its QP carries the
    Hessian's condition ~1e9), atol 1e-12 times the field's magnitude
    (RALM's subsolver to 5 inner iterations, where the reference is still
    deterministic, ROADMAP.md queue 3); and one RALM outer step on
    LowRank, whose augmented-Lagrangian gradient is taken in the ambient
    space, against JAX's (x compared as the matrix it represents).
(b) Whole runs on LowRank with ``tests/test_embedded.py``'s criteria:
    RIPM with the conjugate residual to residual 1e-6 on that file's
    instance (the JAX-drawn arrays carried across; the JAX run's steps and
    residual, rtol 1e-6), RALM to a least residual below 1e-2 with the
    cost decreasing.
(c) The fixed-rank manifold has no basis: RSQO and RIPM's dense solve
    raise NotImplementedError in both packages.
(d) The solver-generic sweep of each of the four solvers on
    StableIdentification, B = 2 starts, a few steps: RIPTRM, RIPM and
    RSQO residuals against the JAX sweep's (rtol 1e-6), RALM's below its
    starting residual; ``certify_second_order`` against JAX's (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.parallel import sweep as tsw
from riptrm_torch.problems import low_rank as tl
from riptrm_torch.problems import rosenbrock as tr
from riptrm_torch.problems import stable_identification as ts
from riptrm_torch.solvers import ralm as tralm
from riptrm_torch.solvers import ripm as tripm
from riptrm_torch.solvers import rsqo as trsqo
from riptrm_tpu.parallel import sweep as jsw
from riptrm_tpu.problems import low_rank as jl
from riptrm_tpu.problems import rosenbrock as jr
from riptrm_tpu.problems import stable_identification as js
from riptrm_tpu.solvers import ralm as jralm
from riptrm_tpu.solvers import ripm as jripm
from riptrm_tpu.solvers import rsqo as jrsqo

torch.set_num_threads(1)

SID = "dataset/StableIdentification/1"
LOWRANK = "dataset/LowRank/1"
CPU = dict(dtype=torch.float64, device="cpu")


def close(got, want, name, rtol=1e-8):
    want = np.asarray(want, dtype=float)
    scale = max(1.0, float(np.nanmax(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, dtype=float), want, rtol=rtol,
                               atol=1e-12 * scale, equal_nan=True, err_msg=name)


def close_point(man, tx, jx, name, rtol=1e-8, atol=1e-12):
    """A packed torch point [1, ...] against a JAX point (a tuple or one
    array); fixed-rank points as the matrices they represent."""
    if hasattr(man, "embed_point"):
        u, s, v = (np.asarray(a) for a in jx)
        np.testing.assert_allclose(man.embed_point(tx)[0].numpy(), (u * s) @ v.T,
                                   rtol=rtol, atol=atol, err_msg=name)
        return
    parts = man.unpack(tx)
    parts = parts if isinstance(parts, tuple) else (parts,)
    for a, b in zip(parts, jx if isinstance(jx, tuple) else (jx,), strict=True):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (a) one step of each baseline solver from the JAX state
# ---------------------------------------------------------------------------
def families(name):
    if name == "sid":
        return js.load_problem(SID, "a"), ts.load_problem(SID, "a", **CPU)
    if name == "rosenbrock":
        return jr.make_problem(5, 3), tr.make_problem(5, 3, **CPU)
    return jl.load_problem(LOWRANK, "a"), tl.load_problem(LOWRANK, "a", **CPU)


def _compare_state(tp, t_new, j_new, rtol=1e-8):
    jd = jax.device_get(j_new)._asdict()
    td = type(t_new).__dataclass_fields__
    for k, v in jd.items():
        if k not in td or v is None:
            continue
        if k == "x":
            close_point(tp.manifold, t_new.x, v, k, rtol=rtol)
            continue
        close(getattr(t_new, k)[0].numpy(), v, k, rtol)


@pytest.mark.parametrize("name", ["sid", "rosenbrock"])
def test_ripm_dense_step(name):
    jp, tp = families(name)
    jopt, topt = jripm.RIPM({}).option, tripm.RIPM({}).option
    jst, jt1, jt2 = jripm.init_state(jp, jopt)
    jst, _ = jripm.make_step(jp, jopt)(jst, jt1, jt2)  # one step in
    d = jax.device_get(jst)._asdict()
    j_new, _ = jripm.make_step(jp, jopt)(jst, jt1, jt2)
    t_st = tripm.state_from_numpy(d, device="cpu", manifold=tp.manifold)
    t_new, _ = tripm.make_step(tp, topt)(t_st, torch.tensor([float(jt1)]),
                                         torch.tensor([float(jt2)]))
    _compare_state(tp, t_new, j_new)


# Rosenbrock's QP carries the Hessian's condition (~1e9 at alpha = 1e7)
STEP_RTOL = {"sid": 1e-8, "rosenbrock": 1e-5}


@pytest.mark.parametrize("name", ["sid", "rosenbrock"])
def test_rsqo_step(name):
    jp, tp = families(name)
    opt = {"quadoptim_eigvalcorr": 1e-2}
    jopt, topt = jrsqo.RSQO(opt).option, trsqo.RSQO(opt).option
    jst = jrsqo.init_state(jp, jopt)
    d = jax.device_get(jst)._asdict()
    j_new, _ = jrsqo.make_step(jp, jopt)(jst)
    t_new, _ = trsqo.make_step(tp, topt)(
        trsqo.state_from_numpy(d, device="cpu", manifold=tp.manifold))
    _compare_state(tp, t_new, j_new, STEP_RTOL[name])


@pytest.mark.parametrize("name", ["sid", "rosenbrock", "lowrank"])
def test_ralm_step(name):
    """One RALM outer step (the subsolver to 5 inner iterations); on
    LowRank its gradient is the ambient one."""
    jp, tp = families(name)
    opt = {"maxInnerIter": 5}
    jopt, topt = jralm.RALM(opt).option, tralm.RALM(opt).option
    jst = jralm.init_state(jp, jopt)
    d = jax.device_get(jst)._asdict()
    j_new, _ = jralm.make_step(jp, jopt)(jst)
    t_new, _ = tralm.make_step(tp, topt)(
        tralm.state_from_numpy(d, device="cpu", manifold=tp.manifold))
    _compare_state(tp, t_new, j_new)


# ---------------------------------------------------------------------------
# (b) whole runs on LowRank, (c) its refusals
# ---------------------------------------------------------------------------
OPT = {"maxtime": 120, "maxiter": 40, "verbosity": 0}


def test_lowrank_ripm_krylov_run():
    """On ``tests/test_embedded.py``'s instance (its JAX-drawn arrays
    carried across): the JAX run's steps, residual rtol 1e-6.  (On
    dataset/LowRank/1 RIPM stalls near 0.7 in the JAX package itself.)"""
    inst = jl.generate_instance(jax.random.PRNGKey(7), 8, 6, rank=2, noise=0.05)
    x0 = jl.generate_initialpoint(jax.random.PRNGKey(3), 8, 6, 2)
    opt = OPT | {"tolresid": 1e-6, "KrylovIterMethod": True}
    j_out = jripm.RIPM(opt).run(jl.make_problem(inst["A"], x0))
    t_out = tripm.RIPM(opt).run(tl.make_problem(inst["A"], x0, **CPU))
    assert t_out.log["residual"][-1] <= 1e-6
    assert len(t_out.log["residual"]) == len(j_out.log["residual"])
    np.testing.assert_allclose(t_out.log["residual"][-1], j_out.log["residual"][-1],
                               rtol=1e-6)


def test_lowrank_ralm_run():
    _, tp = families("lowrank")
    out = tralm.RALM(OPT | {"maxiter": 20, "tolresid": 1e-4}).run(tp)
    assert min(out.log["residual"]) < 1e-2
    assert out.log["cost"][-1] < out.log["cost"][0]


@pytest.mark.parametrize("solver", ["RSQO", "RIPM"])
def test_fixed_rank_dense_paths_raise_in_both(solver):
    jp, tp = families("lowrank")
    opt = OPT | {"maxiter": 2, "do_exit_on_error": False}
    jcls, tcls = {"RSQO": (jrsqo.RSQO, trsqo.RSQO), "RIPM": (jripm.RIPM, tripm.RIPM)}[solver]
    with pytest.raises(NotImplementedError):
        jcls(opt).run(jp)
    with pytest.raises(NotImplementedError):
        tcls(opt).run(tp)


# ---------------------------------------------------------------------------
# (d) the sweeps on StableIdentification
# ---------------------------------------------------------------------------
SWEEPS = {
    "RIPTRM": ({"maxiter": 30, "tolresid": 1e-8, "TRS_solver": "tCG",
                "second_order_stationarity": False}, 4),
    "RIPM": ({"maxiter": 30, "tolresid": 1e-8}, 3),
    "RSQO": ({"maxiter": 20, "tolresid": 1e-8, "quadoptim_eigvalcorr": 1e-2}, 3),
    "RALM": ({"maxiter": 2, "tolresid": 1e-8, "maxInnerIter": 20}, 2),
}


@pytest.fixture(scope="module")
def sid_starts():
    jp, tp = families("sid")
    starts = [tuple(np.loadtxt(f"{SID}/init{c}_{p}.csv") for c in "JRQ") for p in "ab"]
    xs = tuple(np.stack([s[i] for s in starts]) for i in range(3))
    ys = np.ones((2, jp.num_ineq))
    return jp, tp, xs, ys


@pytest.mark.parametrize("solver", SWEEPS)
def test_sid_sweep_against_jax(sid_starts, solver):
    jp, tp, xs, ys = sid_starts
    option, steps = SWEEPS[solver]
    t_x, _, _, t_res = tsw.batched_solver_sweep(tp, solver, option, steps)(
        tp.manifold.pack(tuple(torch.tensor(a) for a in xs)), torch.tensor(ys))
    assert t_x.shape == (2, 3, 5, 5) and bool(torch.isfinite(t_res).all())
    _, _, _, j_res = jsw.batched_solver_sweep(jp, solver, option, steps)(
        tuple(jnp.asarray(a) for a in xs), jnp.asarray(ys))
    if solver == "RALM":
        start = tsw.compute_residual(tp, tp.manifold.pack(
            tuple(torch.tensor(a) for a in xs)), torch.tensor(ys))[0]
        assert bool((t_res < start).all())
    else:
        np.testing.assert_allclose(t_res.numpy(), np.asarray(j_res), rtol=1e-6)


def test_sid_certify_second_order_against_jax(sid_starts):
    jp, tp, xs, ys = sid_starts
    t_ritz = tsw.certify_second_order(
        tp, tp.manifold.pack(tuple(torch.tensor(a) for a in xs)), torch.tensor(ys),
        num_iters=12)
    j_ritz = jsw.certify_second_order(jp, tuple(jnp.asarray(a) for a in xs),
                                      jnp.asarray(ys), num_iters=12)
    np.testing.assert_allclose(t_ritz.numpy(), np.asarray(j_ritz), rtol=1e-6)

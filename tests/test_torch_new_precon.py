"""RIPM's ``jacobi_theta`` preconditioner on StableIdentification: the
PyTorch port against ``riptrm_tpu``, float64 on the CPU.

The cases of ``tests/test_ripm_precon.py`` on JAX's
``build_sweep("StableIdentification", 3, 1, seed=3)`` data carried
across (its trajectories, constraints and start): the preconditioned
step equals the plain conjugate-residual step at CR tolerance 1e-12
(x rtol 1e-6, atol 1e-8; phi rtol 1e-5, as there), and each equals
the JAX step from the same state (x rtol 1e-7, atol 1e-9: a CR to
1e-12 on a system of condition ~1e6); on widely scaled multipliers
the preconditioned CR needs no more iterations than the plain one in
both packages, and the port's preconditioned count is within one of
the JAX count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.problems import stable_identification as ts
from riptrm_torch.solvers import ripm as tripm
from riptrm_tpu.problems import stable_identification as js
from riptrm_tpu.solvers import ripm as jripm

torch.set_num_threads(1)

CPU = dict(dtype=torch.float64, device="cpu")


def close_point(man, tx, jx, name, rtol, atol):
    """A packed torch point [1, 3, d, d] against a JAX (J, R, Q)."""
    for a, b in zip(man.unpack(tx), jx, strict=True):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def precon_problems():
    from riptrm_tpu.experiment.chip_sweep import _cache_load, build_sweep

    _, xs0, ys0 = build_sweep("StableIdentification", 3, 1, seed=3)
    payload = _cache_load("StableIdentification", 3, 1, 3)
    x0 = tuple(np.asarray(a[0], np.float64) for a in xs0)
    jp = js.make_problem(3, list(payload["trajs"]), payload["constset"], x0)
    tp = ts.make_problem(3, list(payload["trajs"]), payload["constset"], x0, **CPU)
    return jp, tp, x0, np.asarray(ys0[0], np.float64)


def _ripm_starts(jp, tp, x0, y0, option):
    """The start state of ``tests/test_ripm_precon.py::_start_state`` in
    both packages (JAX's carried across)."""
    m = jp.num_ineq
    jx, jy = tuple(jnp.asarray(a) for a in x0), jnp.asarray(y0)
    f = jripm._kkt_field(jp, jx, jnp.zeros((0,)), jy, jy)
    phi0 = jripm._phi(jp, jx, *f)
    st0 = jripm.RipmState(
        x=jx, y=jnp.zeros((0,)), z=jy, s=jy, phi=phi0, sigma=jnp.minimum(0.5, phi0**0.25),
        rho=jnp.vdot(jy, jy) / m, gamma=jnp.asarray(option["gamma"]),
        iteration=jnp.asarray(0),
    )
    tau_1 = jnp.min(jy * jy) * m / jnp.vdot(jy, jy)
    tau_2 = jnp.vdot(jy, jy) / jnp.sqrt(phi0)
    t_st = tripm.state_from_numpy(jax.device_get(st0)._asdict(), device="cpu",
                                  manifold=tp.manifold)
    t_tau = (torch.tensor([float(tau_1)]), torch.tensor([float(tau_2)]))
    return (st0, tau_1, tau_2), (t_st,) + t_tau


def _ripm_step(jp, tp, x0, y0, option):
    jopt, topt = jripm.RIPM(option).option, tripm.RIPM(option).option
    (jst, jt1, jt2), (tst, tt1, tt2) = _ripm_starts(jp, tp, x0, y0, jopt)
    j_new, j_info = jripm.make_step(jp, jopt)(jst, jt1, jt2)
    t_new, t_info = tripm.make_step(tp, topt)(tst, tt1, tt2)
    return (j_new, j_info), (t_new, t_info)


PRECON_BASE = {"KrylovIterMethod": True, "KrylovTolrelresid": 1e-12,
               "KrylovMaxIteration": 3000}


def test_preconditioned_step_matches_unpreconditioned(precon_problems):
    jp, tp, x0, y0 = precon_problems
    (jplain, _), (tplain, _) = _ripm_step(jp, tp, x0, y0, dict(PRECON_BASE))
    (jpre, _), (tpre, _) = _ripm_step(jp, tp, x0, y0,
                                      PRECON_BASE | {"KrylovPreconditioner": "jacobi_theta"})
    for a, b in zip(tp.manifold.unpack(tplain.x), tp.manifold.unpack(tpre.x)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(tplain.phi[0]), float(tpre.phi[0]), rtol=1e-5)
    # each against the JAX step from the same state
    for t_new, j_new in ((tplain, jplain), (tpre, jpre)):
        close_point(tp.manifold, t_new.x, j_new.x, "x", rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(float(t_new.phi[0]), float(j_new.phi), rtol=1e-7)


def test_preconditioner_reduces_cr_iterations(precon_problems):
    jp, tp, x0, _ = precon_problems
    rng = np.random.default_rng(0)
    z0 = 10.0 ** rng.uniform(-4, 2, size=(jp.num_ineq,))
    base = {"KrylovIterMethod": True, "KrylovTolrelresid": 1e-10, "KrylovMaxIteration": 3000}
    its = {}
    for label, opt in (("plain", base), ("pre", base | {"KrylovPreconditioner": "jacobi_theta"})):
        (_, j_info), (_, t_info) = _ripm_step(jp, tp, x0, z0, opt)
        its[label] = (int(t_info["KrylovIterMethod_Iter"][0]),
                      int(j_info["KrylovIterMethod_Iter"]))
    assert its["pre"][0] <= its["plain"][0] and its["pre"][1] <= its["plain"][1], its
    # the scaled system is well conditioned: the same count within one; the
    # plain CR's count on the 1e6-spread system follows its rounding
    assert abs(its["pre"][0] - its["pre"][1]) <= 1, its

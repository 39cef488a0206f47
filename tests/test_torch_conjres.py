"""The port's lane-masked conjugate residual (``riptrm_torch/ops/conjres.py``)
against ``riptrm_tpu/ops/conjres.py``, float64 on the CPU.

Three lanes of random SPD operators (n = 30) of condition 2, 10 and 100:
the first converges in 13 iterations, the other two are capped by
``maxiter`` = 15 (beyond ~15 iterations at condition 100 CR's rounding
drifts in either package); each lane's solution, iteration count and
relative residual against the JAX function on that lane alone, rtol 1e-9.
A lane that has stopped keeps its values bit for bit while the others go
on; a two-part (x, y) vector with ``stop_norm`` as RIPM passes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops.conjres import conjugate_residual as t_cr
from riptrm_tpu.ops.conjres import conjugate_residual as j_cr

torch.set_num_threads(1)
N = 30
MAXITER = 15


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    mats, rhs = [], []
    for cond in (2.0, 10.0, 100.0):
        q, _ = np.linalg.qr(rng.standard_normal((N, N)))
        mats.append((q * np.geomspace(1.0, cond, N)) @ q.T)
        rhs.append(rng.standard_normal(N))
    return np.array(mats), np.array(rhs)


def _t_solve(a, b, maxiter, tol=1e-10):
    at = torch.tensor(a)
    op = lambda v: (torch.einsum("bij,bj->bi", at, v[0]),)
    inner = lambda u, v: torch.sum(u[0] * v[0], dim=-1)
    return t_cr(inner, op, (torch.tensor(b),), (torch.zeros(b.shape, dtype=torch.float64),),
                tol=tol, maxiter=maxiter)


def test_lanes_match_jax_alone(system):
    a, b = system
    (v,), iters, rel = _t_solve(a, b, maxiter=MAXITER)
    for i in range(3):
        jv, jt, jrel = j_cr(lambda u, w: jnp.vdot(u, w), lambda u: jnp.asarray(a[i]) @ u,
                            jnp.asarray(b[i]), jnp.zeros(N), tol=1e-10, maxiter=MAXITER)
        assert int(iters[i]) == int(jt)
        np.testing.assert_allclose(v[i].numpy(), np.asarray(jv), rtol=1e-9, atol=1e-12)
        # a stopped lane's residual lies below tol, where rounding decides it
        np.testing.assert_allclose(float(rel[i]), float(jrel), rtol=1e-9, atol=1e-12)
    # lanes of different lengths, the last two capped by maxiter
    assert iters.tolist() == [13, MAXITER, MAXITER] and float(rel[1]) > 1e-10


def test_stopped_lane_stays_frozen(system):
    a, b = system
    (v_all,), it_all, rel_all = _t_solve(a, b, maxiter=MAXITER)
    first = int(it_all[0])
    assert first < int(it_all[1])
    # the same batch stopped at the first lane's count: every later
    # iteration of the others leaves that lane's values unchanged
    (v_cut,), it_cut, rel_cut = _t_solve(a, b, maxiter=first)
    assert torch.equal(v_all[0], v_cut[0]) and float(rel_all[0]) == float(rel_cut[0])
    assert int(it_cut[0]) == first


def test_product_space_with_stop_norm(system):
    """A (x, y) vector with a diagonal y block and stop_norm on a scaled
    residual, as RIPM's Krylov modes pass them."""
    a, b = system
    rng = np.random.default_rng(1)
    d = np.abs(rng.standard_normal((3, 2))) + 0.5
    c = rng.standard_normal((3, 2))
    scale = np.linspace(1.0, 2.0, N)
    at, dt, st = torch.tensor(a), torch.tensor(d), torch.tensor(scale)
    op = lambda v: (torch.einsum("bij,bj->bi", at, v[0]), dt * v[1])
    inner = lambda u, v: torch.sum(u[0] * v[0], -1) + torch.sum(u[1] * v[1], -1)
    stop = lambda r: torch.sqrt(torch.sum((st * r[0]) ** 2, -1) + torch.sum(r[1] ** 2, -1))
    (vx, vy), iters, rel = t_cr(inner, op, (torch.tensor(b), torch.tensor(c)),
                                (torch.zeros(3, N, dtype=torch.float64),
                                 torch.zeros(3, 2, dtype=torch.float64)),
                                tol=1e-9, maxiter=MAXITER, stop_norm=stop)
    for i in range(3):
        (jx, jy), jt, jrel = j_cr(
            lambda u, w: jnp.vdot(u[0], w[0]) + jnp.vdot(u[1], w[1]),
            lambda u: (jnp.asarray(a[i]) @ u[0], jnp.asarray(d[i]) * u[1]),
            (jnp.asarray(b[i]), jnp.asarray(c[i])), (jnp.zeros(N), jnp.zeros(2)),
            tol=1e-9, maxiter=MAXITER,
            stop_norm=lambda r: jnp.sqrt(jnp.sum((scale * r[0]) ** 2) + jnp.sum(r[1] ** 2)),
        )
        # to 1e-9 of the vector's scale (~0.3): its small entries carry
        # the capped lanes' rounding
        assert int(iters[i]) == int(jt)
        np.testing.assert_allclose(vx[i].numpy(), np.asarray(jx), rtol=1e-9, atol=3e-10)
        np.testing.assert_allclose(vy[i].numpy(), np.asarray(jy), rtol=1e-9, atol=3e-10)

"""Sphere ops of the PyTorch port against ``riptrm_tpu.manifolds.Sphere``.

The same numpy inputs go through both packages, lane by lane (the port
carries a leading lane axis; the JAX sphere acts on one point).  float64,
atol 1e-12: the ops are a few flops deep, so both sides agree to roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.manifolds import Sphere as TSphere
from riptrm_tpu.manifolds import Sphere as JSphere

torch.set_num_threads(1)

N = 7
ATOL = 1e-12


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, N))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = rng.standard_normal((b, N))
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    amb = [rng.standard_normal((b, N)) for _ in range(3)]
    # tangent vectors at x (and a small step for the retraction)
    u, v = [a - np.sum(a * x, 1, keepdims=True) * x for a in amb[:2]]
    return x, y, u, v, amb[2]


OPS = {
    "inner": lambda m, x, y, u, v, a: m.inner(x, u, v),
    "norm": lambda m, x, y, u, v, a: m.norm(x, u),
    "proj": lambda m, x, y, u, v, a: m.proj(x, a),
    "proj_tangent": lambda m, x, y, u, v, a: m.proj_tangent(x, a),
    "retract": lambda m, x, y, u, v, a: m.retract(x, 0.3 * u),
    "dist": lambda m, x, y, u, v, a: m.dist(x, y),
    "zero_vector": lambda m, x, y, u, v, a: m.zero_vector(x),
    "egrad2rgrad": lambda m, x, y, u, v, a: m.egrad2rgrad(x, a),
    "ehess2rhess": lambda m, x, y, u, v, a: m.ehess2rhess(x, a, v, u),
    "transport": lambda m, x, y, u, v, a: m.transport(x, y, u),
}


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("op", sorted(OPS))
def test_sphere_op_matches_jax(op, b):
    arrays = _inputs(b)
    got = OPS[op](TSphere(N), *[torch.as_tensor(a) for a in arrays]).numpy()
    assert got.shape[0] == b
    jman = JSphere(N)
    for i in range(b):
        want = np.asarray(OPS[op](jman, *[jnp.asarray(a[i]) for a in arrays]))
        np.testing.assert_allclose(got[i], want, atol=ATOL)


def test_sphere_static_properties():
    assert TSphere(N).dim == JSphere(N).dim == N - 1
    assert TSphere(50).typical_dist == pytest.approx(JSphere(50).typical_dist)


@pytest.mark.parametrize("b", [1, 3])
def test_random_tangent_unit_and_tangent(b):
    man = TSphere(10)
    g = torch.Generator().manual_seed(1)
    x = man.random_point(g, b, device="cpu")
    u = man.random_tangent(x, g)
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=-1).numpy(), 1.0, atol=ATOL)
    np.testing.assert_allclose(man.norm(x, u).numpy(), 1.0, atol=ATOL)
    np.testing.assert_allclose(man.inner(x, x, u).numpy(), 0.0, atol=ATOL)
    # retraction stays on the sphere (test_manifolds.py::test_sphere_feasibility)
    y = man.retract(x, u)
    np.testing.assert_allclose(torch.linalg.vector_norm(y, dim=-1).numpy(), 1.0, atol=ATOL)


def test_projection_idempotent_and_rhess_symmetric():
    x, _, u, w, a = [torch.as_tensor(t) for t in _inputs(3, seed=2)]
    man = TSphere(N)
    pa = man.proj(x, a)
    np.testing.assert_allclose(man.proj(x, pa).numpy(), pa.numpy(), atol=ATOL)
    # rhess of f(p) = (a.p)^2 + 0.5 p.p is self-adjoint on T_x
    def rhess(v):
        eg = 2.0 * torch.sum(a * x, -1, keepdim=True) * a + x
        eh = 2.0 * torch.sum(a * v, -1, keepdim=True) * a + v
        return man.ehess2rhess(x, eg, eh, v)
    np.testing.assert_allclose(
        man.inner(x, rhess(u), w).numpy(), man.inner(x, u, rhess(w)).numpy(), atol=ATOL
    )
    # and equals the JAX sphere's rhess lane by lane
    jman = JSphere(N)
    for i in range(3):
        xi, ai, ui = (jnp.asarray(t[i].numpy()) for t in (x, a, u))
        f = lambda p: jnp.vdot(ai, p) ** 2 + 0.5 * jnp.vdot(p, p)
        eg, eh = jax.jvp(jax.grad(f), (xi,), (ui,))
        np.testing.assert_allclose(
            rhess(u)[i].numpy(), np.asarray(jman.ehess2rhess(xi, eg, eh, ui)), atol=ATOL
        )

"""Stiefel ops and the truncated CG on St(n, p) of the PyTorch port against
``riptrm_tpu``.

(a) ``Stiefel`` ops at (n, p) = (10, 3) over B = 3 lanes, lane by lane
    against ``riptrm_tpu.manifolds.Stiefel`` on the same numpy inputs;
    float64, atol 1e-12 (a few flops deep; the polar retraction goes
    through an SVD in each package, which agree to ~1e-14 here).
(b) ``truncated_cg`` on St(30, 3) (the golden BoundedPCA instance) with
    each package's own AD barrier operator: iterations and stop codes equal,
    eta to atol 1e-10 (float64 CG on a moderately conditioned operator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.manifolds import Stiefel as TStiefel
from riptrm_torch.manifolds import skew, sym
from riptrm_torch.ops.tcg import truncated_cg as t_tcg
from riptrm_torch.problems import bounded_pca as tb
from riptrm_torch.solvers import riptrm as t_riptrm
from riptrm_tpu.manifolds import base as jbase
from riptrm_tpu.manifolds.stiefel import Stiefel as JStiefel
from riptrm_tpu.ops.tcg import truncated_cg as j_tcg
from riptrm_tpu.problems import bounded_pca as jb
from riptrm_tpu.solvers import riptrm as j_riptrm

torch.set_num_threads(1)

N, P, B = 10, 3, 3
ATOL = 1e-12


def _frame(rng, b):
    q, _ = np.linalg.qr(rng.standard_normal((b, N, P)))
    return q


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x, y = _frame(rng, B), _frame(rng, B)
    amb = [rng.standard_normal((B, N, P)) for _ in range(3)]
    # tangent vectors at x
    u, v = [a - x @ (0.5 * (np.swapaxes(x, 1, 2) @ a + np.swapaxes(a, 1, 2) @ x))
            for a in amb[:2]]
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


@pytest.mark.parametrize("op", sorted(OPS))
def test_stiefel_op_matches_jax(op):
    arrays = _inputs()
    got = OPS[op](TStiefel(N, P), *[torch.as_tensor(a) for a in arrays]).numpy()
    assert got.shape[0] == B
    jman = JStiefel(N, P)
    for i in range(B):
        want = np.asarray(OPS[op](jman, *[jnp.asarray(a[i]) for a in arrays]))
        np.testing.assert_allclose(got[i], want, atol=ATOL, err_msg=str(i))


def test_stiefel_static_properties():
    for n, p in ((N, P), (128, 8), (512, 32)):
        assert TStiefel(n, p).dim == JStiefel(n, p).dim == n * p - p * (p + 1) // 2
        assert TStiefel(n, p).typical_dist == pytest.approx(JStiefel(n, p).typical_dist)


def test_sym_skew_match_jax():
    a = np.random.default_rng(1).standard_normal((B, 4, 4))
    t = torch.as_tensor(a)
    np.testing.assert_array_equal(sym(t).numpy(), np.asarray(jbase.sym(jnp.asarray(a))))
    np.testing.assert_array_equal(skew(t).numpy(), np.asarray(jbase.skew(jnp.asarray(a))))
    np.testing.assert_allclose((sym(t) + skew(t)).numpy(), a, atol=1e-15)


def test_random_point_and_tangent():
    man = TStiefel(N, P)
    g = torch.Generator().manual_seed(1)
    x = man.random_point(g, B, device="cpu")
    u = man.random_tangent(x, g)
    eye = np.broadcast_to(np.eye(P), (B, P, P))
    np.testing.assert_allclose((x.mT @ x).numpy(), eye, atol=ATOL)
    np.testing.assert_allclose(man.norm(x, u).numpy(), 1.0, atol=ATOL)
    # tangent: X'U + U'X = 0
    np.testing.assert_allclose(sym(x.mT @ u).numpy(), 0.0, atol=ATOL)
    # the polar retraction stays on St(n, p)
    y = man.retract(x, u)
    np.testing.assert_allclose((y.mT @ y).numpy(), eye, atol=ATOL)


def test_rhess_self_adjoint():
    """The Riemannian Hessian of f(X) = tr(X'AX) with A symmetric is
    self-adjoint on T_x (the outer projection of ``ehess2rhess``)."""
    x, _, u, w, a = (torch.as_tensor(t) for t in _inputs(seed=2))
    a = torch.as_tensor(np.random.default_rng(3).standard_normal((N, N)))
    a = a + a.T
    man = TStiefel(N, P)
    rhess = lambda v: man.ehess2rhess(x, 2.0 * a @ x, 2.0 * a @ v, v)
    np.testing.assert_allclose(man.inner(x, rhess(u), w).numpy(),
                               man.inner(x, u, rhess(w)).numpy(), atol=ATOL)
    np.testing.assert_allclose(sym(x.mT @ rhess(u)).numpy(), 0.0, atol=ATOL)


# ---------------------------------------------------------------------------
# (b) truncated CG on St(30, 3)
# ---------------------------------------------------------------------------
DATA = "dataset/BoundedPCA/1"
TCG_ATOL = 1e-10


@pytest.fixture(scope="module")
def golden():
    return jb.load_problem(DATA, "a"), tb.load_problem(DATA, "a", device="cpu")


def _jax_tcg(jp, x, y, mu, radius):
    _, hw, cx = j_riptrm._barrier_ops(jp, x, y, mu)
    dim = jp.manifold.dim
    f = jax.jit(lambda cx, r: j_tcg(jp.manifold, x, hw, cx, r, maxinner=dim))
    eta, heta, it, code = f(cx, radius)
    return np.asarray(eta), np.asarray(heta), int(it), int(code)


def test_tcg_lanes_on_stiefel_match_jax(golden):
    """Four states of the port's own golden trajectory (steps 0, 12, 25 and
    40, where the tCG runs 1 to 43 iterations) with mixed radii: one
    lane-batched call against four JAX calls on the same numpy inputs."""
    jp, tp = golden
    n, p = jp.manifold.n, jp.manifold.p
    opt = t_riptrm.RIPTRM({"TRS_solver": "tCG", "second_order_stationarity": False}).option
    step = t_riptrm.make_step(tp, opt)
    st, states = t_riptrm.init_state(tp, opt), []
    for k in range(41):
        if k in (0, 12, 25, 40):
            states.append(st)
        st, _ = step(st)
    xs, ys, mus = (torch.cat([getattr(s, f) for s in states]) for f in ("x", "y", "mu"))
    radii = torch.tensor([0.05, 0.2, 1.0, 3.0], dtype=torch.float64)

    _, hw, cx = t_riptrm._barrier_ops(tp, xs, ys, mus)
    etas, hetas, iters, codes = t_tcg(tp.manifold, xs, hw, cx, radii,
                                      maxinner=tp.manifold.dim)
    assert etas.shape == (4, n, p) and iters.dtype == codes.dtype == torch.int32
    for i in range(4):
        eta_j, heta_j, it_j, code_j = _jax_tcg(
            jp, jnp.asarray(xs[i].numpy()), jnp.asarray(ys[i].numpy()), float(mus[i]),
            float(radii[i]),
        )
        assert (int(iters[i]), int(codes[i])) == (it_j, code_j), i
        np.testing.assert_allclose(etas[i].numpy(), eta_j, atol=TCG_ATOL, err_msg=str(i))
        np.testing.assert_allclose(hetas[i].numpy(), heta_j, atol=TCG_ATOL, err_msg=str(i))
    # the lanes stop at different iterations, for different reasons
    assert len(set(iters.tolist())) == 4 and len(set(codes.tolist())) > 1

"""The sphere-quadratic kernels of the PyTorch port (``ops/kernels.py``).

On the CPU each wrapper runs its plain PyTorch version; those are held to
the JAX Pallas kernels themselves, run in interpret mode exactly as
``tests/test_pallas.py`` runs them, at n = 64 and float32, with the JAX
suite's own tolerances: K1 atol 2e-4; K2 atol 1e-4, rtol 1e-3; K3 atol
2e-4, rtol 1e-3; iteration counts and stop codes equal.  The CUDA kernels
themselves are compared with the plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from riptrm_torch.ops import kernels as tk
from riptrm_tpu.ops import pallas_kernels as pk
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers.riptrm import RIPTRM, _barrier_ops, init_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """``tests/test_pallas.py``'s n = 64 float32 fixture, as numpy arrays."""
    n = 64
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    data = jn.generate_instance(k1, n)
    x0 = np.abs(np.asarray(jax.random.normal(k2, (n,))))
    x0 /= np.linalg.norm(x0)
    problem = jn.make_problem(data["Z"], x0, dtype=jnp.float32)
    opt = RIPTRM({"TRS_solver": "tCG", "second_order_stationarity": False}).option
    st = init_state(problem, opt)
    c, _, cx = _barrier_ops(problem, st.x, st.y, st.mu)
    v0 = problem.manifold.random_tangent(jax.random.PRNGKey(1), st.x)
    return {
        "problem": problem,
        "zs": np.asarray(problem.structure["Zs"]),
        "x": np.asarray(st.x),
        "w": np.asarray(st.y / c),
        "grad": np.asarray(cx),
        "radius": float(st.tr_radius),
        "v0": np.asarray(v0, np.float32),
        "dim": problem.manifold.dim,
    }


def _t(a):
    return torch.tensor(np.asarray(a))


def _lanes(setup, b):
    """B lanes with mixed radii (``test_pallas.py::test_batched_tcg_interpret``)."""
    problem, n = setup["problem"], setup["zs"].shape[0]
    xs = jnp.abs(jax.random.normal(jax.random.PRNGKey(6), (b, n), dtype=jnp.float32))
    xs = xs / jnp.linalg.norm(xs, axis=1, keepdims=True)
    ys = 0.5 + jnp.abs(jax.random.normal(jax.random.PRNGKey(7), (b, n), dtype=jnp.float32))
    radii = jnp.asarray(([0.1, 0.3, 0.5, 0.2] * 3)[:b], jnp.float32)
    grads = jnp.stack(
        [_barrier_ops(problem, xs[i], ys[i], jnp.float32(0.05))[2] for i in range(b)]
    )
    return xs, ys / xs, grads, radii  # slack = x for NonnegPCA


def test_chained_matvec_plain_matches_pallas(setup):
    s = setup
    with pltpu.force_tpu_interpret_mode():
        want = pk.chained_barrier_matvec(
            jnp.asarray(s["zs"]), jnp.asarray(s["x"]), jnp.asarray(s["w"]),
            jnp.asarray(s["v0"]), 3,
        )
    got = tk.chained_barrier_matvec(_t(s["zs"]), _t(s["x"]), _t(s["w"]), _t(s["v0"]), 3)
    assert got.dtype == torch.float32 and got.shape == (s["zs"].shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_fused_tcg_plain_matches_pallas(setup):
    s = setup
    with pltpu.force_tpu_interpret_mode():
        eta_p, heta_p, it_p, code_p = pk.pallas_tcg_sphere_quadratic(
            jnp.asarray(s["zs"]), jnp.asarray(s["x"]), jnp.asarray(s["w"]),
            jnp.asarray(s["grad"]), s["radius"], maxinner=s["dim"],
        )
    eta, heta, it, code = tk.fused_tcg_sphere_quadratic(
        _t(s["zs"]), _t(s["x"]), _t(s["w"]), _t(s["grad"]), s["radius"],
        maxinner=s["dim"],
    )
    assert it.dtype == code.dtype == torch.int32
    assert int(it) == int(it_p)
    assert int(code) == int(code_p)
    np.testing.assert_allclose(eta.numpy(), np.asarray(eta_p), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(heta.numpy(), np.asarray(heta_p), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("b", [4, 9])
def test_batched_tcg_plain_matches_pallas(setup, b):
    s = setup
    xs, ws, grads, radii = _lanes(s, b)
    with pltpu.force_tpu_interpret_mode():
        etas_p, _, iters_p, codes_p = pk.pallas_tcg_sphere_quadratic_batched(
            jnp.asarray(s["zs"]), xs, ws, grads, radii, maxinner=s["dim"]
        )
    etas, _, iters, codes = tk.fused_tcg_sphere_quadratic_batched(
        _t(s["zs"]), _t(xs), _t(ws), _t(grads), _t(radii), maxinner=s["dim"]
    )
    assert iters.tolist() == [int(v) for v in iters_p]
    assert codes.tolist() == [int(v) for v in codes_p]
    np.testing.assert_allclose(etas.numpy(), np.asarray(etas_p), atol=2e-4, rtol=1e-3)


def test_cpu_tensors_take_the_plain_path(setup):
    s = setup
    tk.reset_launch_counts()
    zs, x, w, g, v0 = (_t(s[k]) for k in ("zs", "x", "w", "grad", "v0"))
    tk.chained_barrier_matvec(zs, x, w, v0, 2)
    tk.fused_tcg_sphere_quadratic(zs, x, w, g, s["radius"], maxinner=s["dim"])
    tk.fused_tcg_sphere_quadratic_batched(
        zs, torch.stack([x, x]), torch.stack([w, w]), torch.stack([g, g]),
        torch.tensor([0.1, 0.2]), maxinner=s["dim"],
    )
    tk.dense_solve_nan(torch.eye(3)[None] + 0.1, torch.ones(1, 3))
    eye = torch.eye(2)[None]
    tk.stableid_barrier_hvp(torch.cat((0 * eye, eye, eye))[None], eye, torch.ones(1, 1),
                            torch.ones(1, 1), torch.ones(1, 3, 2, 2), gram=eye[0],
                            idx=torch.tensor([1]), lin=torch.ones(1), two=torch.zeros(1),
                            p1=torch.zeros(1), scale=0.1)
    tk.spd_cho_solve(torch.eye(2)[None], torch.ones(1, 2, 2))
    assert tk.launch_counts() == {
        "chained_barrier_matvec": 0,
        "fused_tcg_sphere_quadratic": 0,
        "fused_tcg_sphere_quadratic_batched": 0,
        "fused_tcg_stiefel_bound_batched": 0,
        "bare_matvec_chain": 0,
        "chained_barrier_matvec_hbm": 0,
        "dense_solve_nan": 0,
        "stableid_barrier_hvp": 0,
        "spd_cho_solve": 0,
    }


def test_wrappers_refuse_other_devices(setup):
    s = setup
    zs, x, w, v0 = (_t(s[k]) for k in ("zs", "x", "w", "v0"))
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.chained_barrier_matvec(zs.to("meta"), x.to("meta"), w.to("meta"), v0.to("meta"), 1)
    with pytest.raises(ValueError, match="several devices"):
        tk.chained_barrier_matvec(zs.to("meta"), x, w, v0, 1)
    eye = torch.eye(2)[None]
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.spd_cho_solve(eye.to("meta"), eye.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        tk.spd_cho_solve(eye.to("meta"), eye)


def test_kernel_size_limit():
    """The tCG kernel keeps 8 n-vectors of a lane in shared memory: an n
    beyond that is refused before any launch."""
    tk._check_smem(7232, 8)
    with pytest.raises(ValueError, match="shared memory"):
        tk._check_smem(7233, 8)

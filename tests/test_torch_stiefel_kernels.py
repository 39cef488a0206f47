"""The Stiefel-bound fused tCG of the PyTorch port (``ops/kernels.py``).

On the CPU ``fused_tcg_stiefel_bound_batched`` runs its plain version.
That is held to BOTH JAX Pallas kernels it replaces, run in interpret mode
as ``tests/test_pallas.py`` runs them: K4a ``pallas_tcg_stiefel_bound_batched``
(lane-major) and K4b ``pallas_tcg_stiefel_bound_batched_pmajor`` (p-major,
whole batch and 2-lane blocks), at (n, p, B) = (32, 4, 5), and K4a at a
p > 16 shape, (40, 18, 3), where the JAX sweep takes K4a.  Inputs are
the subproblems of a BoundedPCA solve (``_lanes``), float32.  Iterations and stop
codes equal; eta to atol 1e-5, rtol 1e-4 and Heta to atol 1e-4, rtol 1e-3,
the JAX suite's own bounds between its two layouts.  The CUDA kernel is
held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from riptrm_torch.ops import kernels as tk
from riptrm_torch.problems import bounded_pca as tb
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.ops import pallas_kernels as pk
from riptrm_tpu.problems import bounded_pca as jb
from riptrm_tpu.solvers.riptrm import _barrier_ops

torch.set_num_threads(1)


def _lanes(n, p, seed, steps, radii):
    """Subproblems the solver poses on a BoundedPCA instance from the JAX
    generators (seeded): the states of a float64 RIPTRM tCG run at the given
    steps, one lane each, as float32 numpy arrays, with W and S from the JAX
    function and the gradient from the JAX barrier operator.  States along
    a run give tCGs of 1 to ~30 iterations that stop on the trust region or
    on the target; deeper float32 tCGs stop at a different iteration even
    between the two JAX layouts, so they are not used here."""
    key = jax.random.PRNGKey(seed)
    z = np.asarray(jb.generate_instance(jax.random.fold_in(key, 0), n)["Z"])
    x0 = jb.generate_initialpoint(jax.random.fold_in(key, 1), n, p)
    tp = tb.make_problem(z, x0, device="cpu")
    opt = trm.RIPTRM({"TRS_solver": "tCG", "second_order_stationarity": False}).option
    step, st, states = trm.make_step(tp, opt), trm.init_state(tp, opt), []
    for k in range(max(steps) + 1):
        if k in steps:
            states.append(st)
        st, _ = step(st)
    xs, ys, mus = (np.concatenate([getattr(s, f).numpy() for s in states]).astype(np.float32)
                   for f in ("x", "y", "mu"))
    problem = jb.make_problem(z, x0, dtype=jnp.float32)
    cs = jax.vmap(problem.slack)(jnp.asarray(xs))
    grads = jnp.stack([
        _barrier_ops(problem, jnp.asarray(xs[i]), jnp.asarray(ys[i]), jnp.float32(mus[i]))[2]
        for i in range(len(steps))
    ])
    zs, d = problem.structure["Zs"], problem.structure["d"]
    ws, ss = jax.vmap(lambda x, y, c: pk._stiefel_bound_pieces(zs, d, x, y, c))(
        jnp.asarray(xs), jnp.asarray(ys), cs)
    arrays = dict(zs=zs, d=d, xs=xs, ys=ys, cs=cs, ws=ws, ss=ss, grads=grads,
                  radii=np.asarray(radii, np.float32))
    return {k: np.asarray(v) for k, v in arrays.items()}, problem.manifold.dim


@pytest.fixture(scope="module")
def narrow():
    return _lanes(32, 4, 20, steps=(0, 8, 12, 16, 22), radii=(0.05, 2.0, 0.3, 2.0, 2.0))


@pytest.fixture(scope="module")
def wide():
    return _lanes(40, 18, 30, steps=(0, 10, 16), radii=(0.05, 2.0, 0.3))


KERNEL_ARGS = ("zs", "d", "xs", "ws", "ss", "grads", "radii")


def _plain(a, dim):
    out = tk.fused_tcg_stiefel_bound_batched(
        *(torch.tensor(a[k]) for k in KERNEL_ARGS), maxinner=dim
    )
    return [o.numpy() for o in out]


def _assert_same(got, want):
    eta, heta, iters, codes = got
    assert iters.dtype == codes.dtype == np.int32
    np.testing.assert_array_equal(iters, np.asarray(want[2]))
    np.testing.assert_array_equal(codes, np.asarray(want[3]))
    np.testing.assert_allclose(eta, np.asarray(want[0]), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(heta, np.asarray(want[1]), atol=1e-4, rtol=1e-3)


def test_plain_matches_k4a_lane_major(narrow):
    a, dim = narrow
    with pltpu.force_tpu_interpret_mode():
        want = pk.pallas_tcg_stiefel_bound_batched(
            *(jnp.asarray(a[k]) for k in KERNEL_ARGS), maxinner=dim
        )
    got = _plain(a, dim)
    _assert_same(got, want)
    assert got[0].shape == (5, 32, 4) and got[0].dtype == np.float32
    assert max(got[2]) > 20


@pytest.mark.parametrize("lane_block", [None, 2])
def test_plain_matches_k4b_pmajor(narrow, lane_block):
    """Whole batch, and 2-lane blocks with edge padding."""
    a, dim = narrow
    with pltpu.force_tpu_interpret_mode():
        want = pk.pallas_tcg_stiefel_bound_batched_pmajor(
            *(jnp.asarray(a[k]) for k in KERNEL_ARGS), maxinner=dim, lane_block=lane_block
        )
    _assert_same(_plain(a, dim), want)


def test_plain_matches_k4a_wide_frames(wide):
    """p = 18 > 16, where the JAX sweep routes to the lane-major kernel."""
    a, dim = wide
    with pltpu.force_tpu_interpret_mode():
        want = pk.pallas_tcg_stiefel_bound_batched(
            *(jnp.asarray(a[k]) for k in KERNEL_ARGS), maxinner=dim
        )
    _assert_same(_plain(a, dim), want)


def test_lanes_stop_differently(narrow):
    """The fixture exercises the per-lane exit: every lane stops at its own
    iteration, on the trust region (code 2) or on the target (code 5)."""
    a, dim = narrow
    _, _, iters, codes = _plain(a, dim)
    assert len(set(iters.tolist())) == 5 and set(codes.tolist()) == {2, 5}


def test_pieces_match_jax(narrow):
    """W and S against ``_stiefel_bound_pieces``, from float32 inputs: both
    take the same float32 products, in their own summation order."""
    a, _ = narrow
    ws, ss = tk.stiefel_bound_pieces(*(torch.tensor(a[k]) for k in ("zs", "d", "xs", "ys", "cs")))
    assert ws.dtype == ss.dtype == torch.float32
    np.testing.assert_allclose(ws.numpy(), a["ws"], rtol=1e-6)
    np.testing.assert_allclose(ss.numpy(), a["ss"], rtol=1e-5, atol=1e-5)
    # from float64 inputs, the pieces are still float32, as in JAX
    ws64, _ = tk.stiefel_bound_pieces(
        *(torch.tensor(a[k]).double() for k in ("zs", "d", "xs", "ys", "cs"))
    )
    assert ws64.dtype == torch.float32


def test_cpu_tensors_take_the_plain_path(narrow):
    a, dim = narrow
    tk.reset_launch_counts()
    args = [torch.tensor(a[k]) for k in KERNEL_ARGS]
    got = tk.fused_tcg_stiefel_bound_batched(*args, maxinner=dim)
    want = tk.fused_tcg_stiefel_bound_plain(*args, maxinner=dim)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # a scalar radius is broadcast over the lanes
    one = tk.fused_tcg_stiefel_bound_batched(*args[:-1], 0.3, maxinner=dim)
    assert one[2].shape == (5,)
    assert tk.launch_counts()["fused_tcg_stiefel_bound_batched"] == 0


def test_wrapper_refuses_bad_input(narrow):
    a, dim = narrow
    args = [torch.tensor(a[k]) for k in KERNEL_ARGS]
    with pytest.raises(ValueError, match="shape mismatch"):
        tk.fused_tcg_stiefel_bound_batched(*args[:4], args[4][:, :2], *args[5:], maxinner=dim)
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.fused_tcg_stiefel_bound_batched(*(t.to("meta") for t in args), maxinner=dim)


def test_shared_memory_plan():
    """Zs in shared memory at St(128, 8) on every cluster size; at St(512,
    32) the slice's Zs is read through L2 beside the whole delta and the
    slice's frames; a p above 32, or an n whose delta and frames do not
    fit one block even on a cluster of 8, is refused."""
    for b in (1, 16, 64, 128):
        assert tk.stiefel_plan(128, 8, b).zs_shared
    assert tk.stiefel_plan(200, 16, 4).zs_shared
    assert not tk.stiefel_plan(512, 32, 16).zs_shared
    plan = tk.stiefel_plan(128, 8, 128)
    assert plan.smem == 4 * tk._stiefel_floats(128, 8, 1, 128, plan.splits, True) <= tk.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="p <= 32"):
        tk.stiefel_plan(1000, 160, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tk.stiefel_plan(3000, 8, 1)

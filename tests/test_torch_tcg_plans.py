"""The plans of the fused tCG kernels (``ops/kernels.py::tcg_plan`` for the
sphere, K2/K3; ``stiefel_plan`` for the Stiefel-bound kernel, K4a/K4b) and
the route through them that the problem layer gives the solver
(``Problem.fused_tcg_at``, ``problems/structured.py``), on the CPU: pure
arithmetic on shapes, with H100_SMS = 132 SMs.

The fused route of ``make_step`` is also held to the JAX package's
``use_pallas_tcg`` step (its Pallas kernels in interpret mode) from the
same float64 state: both run the tCG in float32, so the new point agrees
to rtol 1e-5 (eta moves by ~1e-7 relative between two float32 summation
orders), the new multipliers to rtol 1e-4 (see the test), and the tCG
iteration count and stop code exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from riptrm_torch.manifolds import Sphere, Stiefel
from riptrm_torch.ops import kernels as tk
from riptrm_torch.problems import bounded_pca as tb
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.problems.problem import Problem
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.problems import bounded_pca as jb
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import riptrm as jrm

torch.set_num_threads(1)

ENTRIES = ("fused_tcg_sphere_quadratic", "fused_tcg_sphere_quadratic_batched",
           "fused_tcg_stiefel_bound_batched")
SLICE = {"TRS_solver": "tCG", "second_order_stationarity": False}


# ---------------------------------------------------------------------------
# K2/K3: tcg_plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,grid,groups,rows,lmax,chunk", [
    (1, 125, 1, 8, 1, 0),  # one lane whole in every CTA, one grid step an iteration
    (16, 125, 1, 8, 16, 1024),  # one group: all of delta staged at once
    (128, 132, 4, 31, 32, 256),  # four groups of 32 lanes, 33 row blocks
])
def test_tcg_plan_at_n_1000(b, grid, groups, rows, lmax, chunk):
    p = tk.tcg_plan(1000, b)
    assert p.route == "resident"
    assert (p.grid, p.groups, p.rows, p.owned, p.lmax, p.chunk) == (
        grid, groups, rows, 1, lmax, chunk)
    assert p.grid <= tk.H100_SMS and p.grid % p.groups == 0
    assert p.rows * (p.grid // p.groups) >= 1000 > p.rows * (p.grid // p.groups - 1)
    ldk = 1000
    rpad = -(-p.rows // tk.TCG_ROW_TILE) * tk.TCG_ROW_TILE
    fixed = rpad * ldk + p.owned * 8 * ldk + tk.TCG_PART + b
    assert p.smem == 4 * (fixed + 2 * p.lmax * p.chunk) <= tk.MAX_SMEM_BYTES
    # a larger chunk would not fit twice
    assert b == 1 or p.chunk * 2 > 1024 or 4 * (fixed + 4 * p.lmax * p.chunk) > tk.MAX_SMEM_BYTES


@pytest.mark.parametrize("b,largest", [(1, 2112), (16, 2112), (128, 1056)])
def test_tcg_plan_resident_limit(b, largest):
    """At the resident limit and one above it: the streaming kernel takes
    over, up to its own limit (8 n-vectors of a lane in one block: n <=
    7232), and above that no kernel does."""
    assert tk.tcg_resident_max_n(b) == largest
    assert tk.tcg_plan(largest, b).route == "resident"
    assert tk.tcg_plan(largest + 1, b).route == "stream"
    assert tk.tcg_plan(7232, b).route == "stream"
    assert tk.tcg_plan(7233, b).route == "plain"


def test_tcg_plan_cuts_lanes_into_groups_and_bounds_ownership():
    """More lanes cut into more groups; a CTA owns at most TCG_MAX_OWNED
    lanes and a product has at most TCG_MAX_TILES tiles, past which the
    streaming kernel takes the batch."""
    for b in (2, 33, 64, 100, 128):
        p = tk.tcg_plan(1000, b)
        assert p.route == "resident", b
        assert p.groups <= -(-b // tk.TCG_GROUP_LANES)
        assert p.owned * p.grid >= b and p.owned <= tk.TCG_MAX_OWNED
        tiles = -(-p.rows // tk.TCG_ROW_TILE) * -(-p.lmax // tk.TCG_SLOT_TILE)
        assert tiles <= tk.TCG_MAX_TILES and p.chunk % 128 == 0
    assert tk.tcg_plan(1000, 129).route == "stream"


# ---------------------------------------------------------------------------
# K4: stiefel_plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,p,b,slices,rows,zs_shared", [
    (128, 8, 128, 1, 128, True),  # the B = 128 sweep: one CTA per lane
    (128, 8, 64, 2, 64, True),
    (128, 8, 16, 8, 16, True),  # the B = 16 sweep: clusters of 8
    (128, 8, 1, 8, 16, True),
    (512, 32, 16, 8, 64, False),  # Zs through L2 beside delta and the frames
    (30, 3, 1, 8, 4, True),  # the golden St(30, 3)
    (64, 20, 3, 8, 8, True),
    (1000, 8, 128, 2, 500, False),  # no room at one slice: two waves of clusters
])
def test_stiefel_plan(n, p, b, slices, rows, zs_shared):
    plan = tk.stiefel_plan(n, p, b)
    assert (plan.slices, plan.rows, plan.zs_shared) == (slices, rows, zs_shared)
    assert plan.rows * plan.slices >= n
    assert plan.smem == 4 * tk._stiefel_floats(n, p, slices, rows, plan.splits, zs_shared)
    assert plan.smem <= tk.MAX_SMEM_BYTES
    # Zs through L2 only where the slice does not fit
    assert zs_shared or 4 * tk._stiefel_floats(n, p, slices, rows, 1, True) > tk.MAX_SMEM_BYTES


def test_stiefel_plan_takes_a_cluster_the_card_holds_b_of():
    """Where the card holds fewer than b clusters of 8 at once (the counts
    of ``stiefel_max_clusters``), B = 16 takes clusters of 4, not a
    second wave of 8."""
    assert tk.stiefel_plan(128, 8, 16, 132, (132, 66, 33, 16)).slices == 8
    assert tk.stiefel_plan(128, 8, 16, 132, (132, 66, 33, 14)).slices == 4
    assert tk.stiefel_plan(128, 8, 128, 132, (132, 66, 33, 14)).slices == 1


def test_stiefel_plan_refusals():
    for n, p in ((2864, 8), (1568, 16), (704, 32)):
        tk.stiefel_plan(n, p, 1)
        with pytest.raises(ValueError, match="shared memory"):
            tk.stiefel_plan(n + 1, p, 1)
    with pytest.raises(ValueError, match="p <= 32"):
        tk.stiefel_plan(128, 33, 1)


# ---------------------------------------------------------------------------
# The solver's route
# ---------------------------------------------------------------------------
def kernels_called(monkeypatch, manifold, kind, lanes, per_lane=False):
    """The kernel entries of ``ops/kernels.py`` that ``Problem.fused_tcg_at``
    calls for ``lanes`` lanes of a ``kind`` problem on ``manifold``, in
    order, or None where it gives no fused tCG.  Its Zs is a zero-stride
    view (lane-leading with ``per_lane``) and the entries record their
    calls in place of running, so the plans are asked at their limits."""
    called = []

    def entry(name, at):
        def call(*args, **kw):
            called.append(name)
            x = args[at]
            return x, x, torch.zeros(x.shape[:1] if x.ndim > 1 else ()), torch.zeros(())

        return call

    for name, at in zip(ENTRIES, (1, 1, 2)):
        monkeypatch.setattr(tk, name, entry(name, at))
    monkeypatch.setattr(tk, "stiefel_bound_pieces", lambda *a: (None, None))
    n = manifold.n
    shape = (n,) if isinstance(manifold, Sphere) else (n, manifold.p)
    zs = torch.zeros(()).expand(*(lanes,) * per_lane, n, n)
    structure = kind and {"kind": kind, "Zs": zs, "d": torch.ones(shape[-1])}
    x, y = torch.zeros(lanes, *shape), torch.ones(lanes, 1)
    tcg = Problem(manifold, cost_fn=None, structure=structure).fused_tcg_at(x, y, y)
    if tcg is None:
        return None
    dx, _, _, _ = tcg(x, torch.ones(lanes))
    assert dx.shape == x.shape
    return called


def test_route_is_plain_where_no_kernel_plan_fits(monkeypatch):
    """The fused route holds where a kernel plan does (n = 7232 on the
    sphere: K2 at one lane, K3 at several; St(2864, 8)), and the plain
    truncated_cg runs above (n = 7233, St(2865, 8), p = 33), as the JAX
    package gates on fits_in_vmem; a problem with no structure has no
    fused route."""
    route = functools.partial(kernels_called, monkeypatch)
    for b in (1, 16, 128):
        assert route(Sphere(7232), "sphere_quadratic", b) == [ENTRIES[b > 1]]
        assert route(Sphere(7233), "sphere_quadratic", b) is None
    assert route(Stiefel(2864, 8), "stiefel_bound", 1) == [ENTRIES[2]]
    assert route(Stiefel(2865, 8), "stiefel_bound", 1) is None
    assert route(Stiefel(128, 33), "stiefel_bound", 1) is None
    assert route(Sphere(50), None, 1) is None


def test_make_step_takes_the_plain_tcg_where_the_plan_refuses(monkeypatch):
    """With the plan refusing (as at n = 7233), the fused option's step is
    the plain step: no kernel wrapper is called and every output equals
    the plain route's."""
    tp = tn.load_problem("dataset/NonnegPCA/1", "a", device="cpu")
    opt = trm.RIPTRM(SLICE).option
    st = trm.init_state(tp, opt)
    want, want_info = trm.make_step(tp, opt)(st)
    monkeypatch.setattr(tk, "tcg_plan", lambda n, b, sms: tk.TcgPlan("plain", *[0] * 7))
    monkeypatch.setattr(tk, "fused_tcg_sphere_quadratic",
                        lambda *a, **k: pytest.fail("kernel wrapper called"))
    assert tp.fused_tcg_at(st.x, st.y, tp.slack(st.x)) is None
    got, got_info = trm.make_step(tp, opt | {"use_fused_tcg": True})(st)
    np.testing.assert_array_equal(got.x.numpy(), want.x.numpy())
    assert got_info["tcg_iters"].tolist() == want_info["tcg_iters"].tolist()


def _jax_fused_step(jp, opt, state):
    jopt = jrm.RIPTRM(opt | {"use_pallas_tcg": True}).option
    with pltpu.force_tpu_interpret_mode():
        new, info = jax.jit(jrm.make_step(jp, jopt))(state)
        return jax.device_get(new)._asdict(), jax.device_get(info)


@pytest.mark.parametrize("kind", ["sphere", "stiefel"])
def test_fused_step_matches_jax(kind):
    """One fused step from the initial state of the golden instances
    (``dataset/NonnegPCA/1`` and ``dataset/BoundedPCA/1``, point a,
    float64): the port's kernel route (its plain versions on the CPU)
    against the JAX step with ``use_pallas_tcg``."""
    data = f"dataset/{'NonnegPCA' if kind == 'sphere' else 'BoundedPCA'}/1"
    jmod, tmod = (jn, tn) if kind == "sphere" else (jb, tb)
    jp, tp = jmod.load_problem(data, "a"), tmod.load_problem(data, "a", device="cpu")
    opt = SLICE | {"maxiter": 30}
    jst = jrm.init_state(jp, jrm.RIPTRM(opt).option)
    j_new, j_info = _jax_fused_step(jp, opt, jst)
    t_state = trm.state_from_numpy(jax.device_get(jst)._asdict(), device="cpu")
    t_new, t_info = trm.make_step(tp, trm.RIPTRM(opt | {"use_fused_tcg": True}).option)(t_state)
    assert int(t_info["tcg_iters"][0]) == int(j_info["tcg_iters"])
    assert int(t_info["dxtype"][0]) == int(j_info["dxtype"])
    new = trm.state_to_numpy(t_new)
    np.testing.assert_allclose(new["x"], j_new["x"], rtol=1e-5, atol=1e-9)
    # y_new = mu / c - y Gx*(dx) / c carries dx's float32 difference times
    # y / c (up to ~10 at this point)
    np.testing.assert_allclose(new["y"], j_new["y"], rtol=1e-4)

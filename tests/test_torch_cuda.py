"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked ``cuda``: each test skips where CUDA is absent.  No JAX import, so
the file runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs come from numpy with a seed: a spiked Z, strictly feasible starts
and barrier weights as the solver builds them.  float32; tolerances of
the CPU parity suite (K1 atol 2e-4; K2/K3 atol 2e-4, rtol 1e-3; the
Stiefel-bound kernel eta atol 1e-5, rtol 1e-4 and Heta atol 1e-4, rtol
1e-3, the JAX suite's bounds between its two layouts) with iteration
counts and stop codes equal; the two chains (K5, K6) as stated below.
The families without a kernel (StableIdentification, Rosenbrock,
LowRank) take three RIPTRM steps on the card against the same steps on
the CPU, float64, rtol 1e-8.  Instance batching's per-lane Zs runs K2 and
the Stiefel kernel once a lane at one lane each (K3 never), each launch
at the bounds above; a 'high' problem's gradient (TF32 in its scope)
stays within TF32's elementwise bound of the 'highest' one's.
StableIdentification's barrier operator (K8) against the float64 image
of the same inputs, its lanes' errors within 2 times its plain version's
at the median and the 99th percentile and 8 times at the worst lane (FP32
sums of d terms in another order), at every width its plan takes, and
once a product in a float32 sweep.  The SPD metric's Cholesky solve (K9)
against the float64 solve by the same rule, the same bits from every
layout of its inputs, and once a metric solve in a float32 sweep.
"""

import numpy as np
import pytest
import torch

from riptrm_torch.ops import kernels as tk
from riptrm_torch.problems import bounded_pca, nonneg_pca
from riptrm_torch.solvers.riptrm import RIPTRM, _barrier_ops

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    v = (rng.permutation(n) < int(0.7 * n)) / np.sqrt(int(0.7 * n))
    z = np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((n, n)) / np.sqrt(n)
    x0 = np.abs(rng.standard_normal(n))
    return nonneg_pca.make_problem(z, x0 / np.linalg.norm(x0), dtype=torch.float32,
                                   device=dev)


def _lanes(problem, b, seed=1):
    rng = np.random.default_rng(seed)
    n = problem.manifold.n
    dev = problem.x0.device
    xs = np.abs(rng.standard_normal((b, n)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    ys = 0.5 + np.abs(rng.standard_normal((b, n)))
    xs, ys = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (xs, ys))
    mu = torch.full((b,), 0.05, dtype=torch.float32, device=dev)
    c, _, cx = _barrier_ops(problem, xs, ys, mu)
    radii = torch.tensor(([0.1, 0.3, 0.5, 0.2] * b)[:b], device=dev)
    return problem.structure["Zs"], xs, ys / c, cx, radii


@pytest.mark.parametrize("n", [64, 250])
@pytest.mark.parametrize("b", [1, 4, 9])
def test_batched_tcg_kernel_matches_plain(dev, n, b):
    p = _problem(n, dev)
    args = _lanes(p, b)
    tk.reset_launch_counts()
    etas, hetas, iters, codes = tk.fused_tcg_sphere_quadratic_batched(*args, maxinner=n - 1)
    assert tk.launch_counts()["fused_tcg_sphere_quadratic_batched"] == 1
    e_p, h_p, it_p, code_p = tk.fused_tcg_plain(*args, maxinner=n - 1)
    assert iters.tolist() == it_p.tolist()
    assert codes.tolist() == code_p.tolist()
    torch.testing.assert_close(etas, e_p, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(hetas, h_p, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n", [64, 250])
def test_single_lane_tcg_kernel_matches_plain(dev, n):
    p = _problem(n, dev)
    zs, xs, ws, gs, radii = _lanes(p, 1)
    tk.reset_launch_counts()
    eta, heta, it, code = tk.fused_tcg_sphere_quadratic(zs, xs[0], ws[0], gs[0], radii[0],
                                                        maxinner=n - 1)
    assert tk.launch_counts()["fused_tcg_sphere_quadratic"] == 1
    e_p, _, it_p, code_p = tk.fused_tcg_plain(zs, xs, ws, gs, radii, maxinner=n - 1)
    assert (int(it), int(code)) == (int(it_p[0]), int(code_p[0]))
    torch.testing.assert_close(eta, e_p[0], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n", [64, 250, 1000, 1001, "largest"])
def test_chain_kernel_matches_plain(dev, n):
    """K1 on its cooperative grid; n = 1001 pads the rows of Zs to 1004 in
    shared memory; "largest" is the largest n the card's SMs hold resident
    (2508 on an H100's 132)."""
    if n == "largest":
        n = tk.chain_resident_max_n(torch.cuda.get_device_properties(dev).multi_processor_count)
    p = _problem(n, dev)
    zs, xs, ws, _, _ = _lanes(p, 1)
    v0 = p.manifold.random_tangent(xs, torch.Generator(dev).manual_seed(2))[0]
    tk.reset_launch_counts()
    out = tk.chained_barrier_matvec(zs, xs[0], ws[0], v0, 16)
    assert tk.launch_counts()["chained_barrier_matvec"] == 1
    ref = tk.chained_barrier_matvec_plain(zs, xs[0], ws[0], v0, 16)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)
    assert torch.equal(out, tk.chained_barrier_matvec(zs, xs[0], ws[0], v0, 16))


def test_chain_kernel_refuses_above_resident_limit(dev):
    """One n past the resident limit of the card's SMs: a ValueError that
    names K6, before any launch."""
    n = tk.chain_resident_max_n(torch.cuda.get_device_properties(dev).multi_processor_count) + 1
    zs = torch.zeros((n, n), device=dev)
    v = torch.ones(n, device=dev) / n ** 0.5
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="chained_barrier_matvec_hbm"):
        tk.chained_barrier_matvec(zs, v, v, v, 4)
    assert tk.launch_counts()["chained_barrier_matvec"] == 0


def test_fused_solver_launches_one_kernel_per_step(dev):
    p = _problem(64, dev)
    opt = {"maxiter": 20, "tolresid": 1e-3, "TRS_solver": "tCG",
           "second_order_stationarity": False, "use_fused_tcg": True,
           "do_exit_on_error": False,
           "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
           "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-4)}
    tk.reset_launch_counts()
    out = RIPTRM(opt).run(p)
    assert tk.launch_counts()["fused_tcg_sphere_quadratic"] == len(out.log["residual"]) - 1
    assert out.log["residual"][-1] <= 1e-3


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("b", [1, 16, 128])
@pytest.mark.parametrize("where", ["n=1000", "resident limit", "above it"])
def test_tcg_kernel_routes_match_plain(dev, b, where):
    """K2 (b = 1) and K3 on each route the plan picks: Zs resident across a
    cooperative grid at n = 1000 and at the resident limit of the card's
    SMs, the streaming kernel one above it; lane 0 (radius 1e-6) stops at
    iteration 1 on the trust region.  In float32 at these n a lane may flip
    a stop threshold between two summation orders (chip_smoke.py phase 4):
    at most 1 of 16 and 6 of 128 lanes may disagree; the others must stop
    as the plain version does, eta within atol 2e-4, rtol 1e-3."""
    n = 1000 if where == "n=1000" else tk.tcg_resident_max_n(b, _sms(dev))
    n += where == "above it"
    assert tk.tcg_plan(n, b, _sms(dev)).route == ("stream" if where == "above it" else
                                                  "resident")
    zs, xs, ws, gs, radii = _lanes(_problem(n, dev), b)
    radii[0] = 1e-6
    kw = dict(maxinner=n - 1)
    tk.reset_launch_counts()
    if b == 1:
        eta, heta, it, code = tk.fused_tcg_sphere_quadratic(zs, xs[0], ws[0], gs[0], radii[0],
                                                            **kw)
        etas, iters, codes = eta[None], it.reshape(1), code.reshape(1)
    else:
        etas, _, iters, codes = tk.fused_tcg_sphere_quadratic_batched(zs, xs, ws, gs, radii,
                                                                      **kw)
    assert sum(tk.launch_counts().values()) == 1
    e_p, _, it_p, code_p = tk.fused_tcg_plain(zs, xs, ws, gs, radii, **kw)
    assert (int(iters[0]), int(codes[0])) == (int(it_p[0]), int(code_p[0]))
    assert int(iters[0]) == 1
    close = torch.isclose(etas, e_p, atol=2e-4, rtol=1e-3).all(dim=1)
    agree = (iters == it_p) & (codes == code_p) & close
    assert int((~agree).sum()) <= {1: 0, 16: 1, 128: 6}[b], torch.nonzero(~agree).tolist()
    if b > 1:  # the same bits on a rerun
        again = tk.fused_tcg_sphere_quadratic_batched(zs, xs, ws, gs, radii, **kw)
        assert torch.equal(again[0], etas) and torch.equal(again[2], iters)


def test_fused_route_takes_plain_tcg_above_the_streaming_limit(dev):
    """n = 7233: no kernel plan holds a lane, so a solve_compiled step with
    use_fused_tcg runs the plain truncated_cg (no kernel launch), as the JAX
    package's fits_in_vmem gate does."""
    from riptrm_torch.solvers.riptrm import init_state

    p = _problem(7233, dev)
    solver = RIPTRM({"maxiter": 5, "tolresid": 1e-3, "TRS_solver": "tCG",
                     "second_order_stationarity": False, "use_fused_tcg": True})
    tk.reset_launch_counts()
    st, k = solver.solve_compiled(p, 1)(init_state(p, solver.option))
    assert int(k[0]) == 1 and sum(tk.launch_counts().values()) == 0
    assert bool(torch.all(torch.isfinite(st.x)))


def _stiefel_lanes(n, p, b, dev, seed=3):
    """Subproblems at St(n, p): a spiked Z and random frames, multipliers
    3 (0.5 + U(0, 1)), mu = 0.01, radii cycling 0.3, 3, 30, 300 (stops on
    negative curvature, on the trust region and on the target)."""
    rng = np.random.default_rng(seed)
    v = (rng.permutation(n) < int(0.7 * n)) / np.sqrt(int(0.7 * n))
    z = np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((n, n)) / np.sqrt(n)
    xs = np.linalg.qr(rng.standard_normal((b, n, p)))[0]
    problem = bounded_pca.make_problem(z, xs[0], dtype=torch.float32, device=dev)
    ys = 3.0 * (0.5 + rng.random((b, problem.num_ineq)))
    xs, ys = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (xs, ys))
    mu = torch.full((b,), 0.01, dtype=torch.float32, device=dev)
    c, _, cx = _barrier_ops(problem, xs, ys, mu)
    zs, d = problem.structure["Zs"], problem.structure["d"]
    ws, ss = tk.stiefel_bound_pieces(zs, d, xs, ys, c)
    radii = torch.tensor(([0.3, 3.0, 30.0, 300.0] * b)[:b], device=dev)
    return (zs, d, xs, ws, ss, cx, radii), problem.manifold.dim


@pytest.mark.parametrize("n,p,b", [
    (128, 8, 1), (128, 8, 16), (128, 8, 128),  # the BoundedPCA sweeps' St(128, 8)
    (512, 32, 16),  # frames in global scratch, Zs through L2
    (200, 16, 4),  # frames in shared memory, Zs through L2
    (64, 20, 3),  # p > 16, all in shared memory
])
def test_stiefel_tcg_kernel_matches_plain(dev, n, p, b):
    args, dim = _stiefel_lanes(n, p, b, dev)
    tk.reset_launch_counts()
    etas, hetas, iters, codes = tk.fused_tcg_stiefel_bound_batched(*args, maxinner=dim)
    assert tk.launch_counts()["fused_tcg_stiefel_bound_batched"] == 1
    e_p, h_p, it_p, code_p = tk.fused_tcg_stiefel_bound_plain(*args, maxinner=dim)
    assert etas.shape == (b, n, p) and iters.dtype == codes.dtype == torch.int32
    assert iters.tolist() == it_p.tolist()
    assert codes.tolist() == code_p.tolist()
    torch.testing.assert_close(etas, e_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(hetas, h_p, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("n,p,b,slices", [
    (128, 8, 128, 1), (128, 8, 64, 2), (128, 8, 16, 4), (128, 8, 8, 8),  # every cluster
    (130, 8, 8, 8),  # ragged: slices of 17 rows, the last 11
    (1000, 8, 4, 8),  # slices of 125 rows, Zs through L2
])
def test_stiefel_kernel_clusters_match_plain(dev, n, p, b, slices):
    """The Stiefel kernel on each cluster size of its plan, against the
    plain version at the tolerances above; each run gives the same bits."""
    clusters = tk.stiefel_clusters(dev.index or 0)
    assert tk.stiefel_plan(n, p, b, _sms(dev), clusters).slices == slices
    args, dim = _stiefel_lanes(n, p, b, dev)
    etas, hetas, iters, codes = tk.fused_tcg_stiefel_bound_batched(*args, maxinner=dim)
    e_p, h_p, it_p, code_p = tk.fused_tcg_stiefel_bound_plain(*args, maxinner=dim)
    assert iters.tolist() == it_p.tolist()
    assert codes.tolist() == code_p.tolist()
    torch.testing.assert_close(etas, e_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(hetas, h_p, atol=1e-4, rtol=1e-3)
    again = tk.fused_tcg_stiefel_bound_batched(*args, maxinner=dim)
    assert torch.equal(again[0], etas) and torch.equal(again[2], iters)


@pytest.mark.parametrize("b", [16, 128])
def test_stiefel_kernel_lane_at_maxinner_beside_early_stops(dev, b):
    """maxinner = 4: lanes that need more iterations stop there with code 0
    while the others stop earlier on their own test, as in the plain
    version (their frozen outputs included)."""
    args, _ = _stiefel_lanes(128, 8, b, dev)
    etas, hetas, iters, codes = tk.fused_tcg_stiefel_bound_batched(*args, maxinner=4)
    e_p, h_p, it_p, code_p = tk.fused_tcg_stiefel_bound_plain(*args, maxinner=4)
    assert iters.tolist() == it_p.tolist() and codes.tolist() == code_p.tolist()
    assert bool(((iters == 4) & (codes == 0)).any()) and bool((iters < 4).any())
    torch.testing.assert_close(etas, e_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(hetas, h_p, atol=1e-4, rtol=1e-3)


def test_fused_bounded_pca_solver_launches_one_kernel_per_step(dev):
    """The golden BoundedPCA solve (float64, the kernel's float32 tCG inside)
    on the fused route: one launch per step, the golden residual and cost."""
    p = bounded_pca.load_problem("dataset/BoundedPCA/1", "a", dtype=torch.float64, device=dev)
    opt = {"maxiter": 40, "tolresid": 1e-8, "TRS_solver": "tCG",
           "second_order_stationarity": False, "use_fused_tcg": True}
    tk.reset_launch_counts()
    out = RIPTRM(opt).run(p)
    assert tk.launch_counts()["fused_tcg_stiefel_bound_batched"] == len(out.log["residual"]) - 1
    assert out.log["residual"][-1] <= 1e-8
    assert out.log["cost"][-1] == pytest.approx(-5.2090815, abs=1e-6)


def test_stiefel_retraction_as_orthonormal_as_on_the_cpu(dev):
    """The polar retraction on the card (``Stiefel.retract``) at St(128, 8),
    B = 16, float32: its factor is no further from orthonormal than 1.5x
    LAPACK's on the CPU on the same inputs, and within 1e-5 of the float64
    factor.  cuSOLVER's default Jacobi driver misses the first bound by
    ~2x, and in a BoundedPCA sweep that noise stalls most lanes."""
    from riptrm_torch.manifolds import Stiefel

    rng = np.random.default_rng(4)
    x = np.linalg.qr(rng.standard_normal((16, 128, 8)))[0]
    v = 0.3 * rng.standard_normal((16, 128, 8))
    man, eye = Stiefel(128, 8), torch.eye(8, dtype=torch.float64)

    def orth_err(y):
        y = y.double().cpu()
        return float(torch.linalg.matrix_norm(y.mT @ y - eye).max())

    f32 = lambda a, d: torch.tensor(a, dtype=torch.float32, device=d)
    on_card = man.retract(f32(x, dev), f32(v, dev))
    on_cpu = man.retract(f32(x, "cpu"), f32(v, "cpu"))
    exact = man.retract(torch.tensor(x), torch.tensor(v))
    assert orth_err(on_card) <= 1.5 * orth_err(on_cpu)
    torch.testing.assert_close(on_card.double().cpu(), exact, atol=1e-5, rtol=0)


# -- K5 bare_matvec_chain and K6 chained_barrier_matvec_hbm -----------------
# K5 tolerances over 64 passes (absolute, on unit-norm rows or columns, of
# entries ~0.03 at n = 1000): 'highest' 1e-5 and 'high' 1e-4 (the same
# float32 products summed in another order); 'default' 3e-3 (an operand one
# ulp apart in the two versions can round to another bf16 value), a few
# times the largest error chip_smoke.py phase 2b reads.  One pass separates
# the rounding rules (relative 2-norm): the same rule agrees to a few 1e-7,
# 'high' lies ~4e-6 from 'highest' and 'default' ~2e-3 from both.
K5_ATOL = {"highest": 1e-5, "high": 1e-4, "default": 3e-3}
ONE_PASS_REL = 1e-6


@pytest.mark.parametrize("precision,left,n,vecs", [
    ("highest", True, 1000, 16),
    ("high", True, 1000, 16),
    ("default", True, 1000, 16),
    ("highest", True, 1001, 3),  # n not a multiple of 4: padded rows
    ("highest", False, 128, 128),  # St(128, 8) frames of 16 lanes
    ("high", False, 128, 1024),
    ("default", False, 128, 64),
    ("highest", False, 200, 12),  # ragged last group
    ("highest", False, 1000, 16),  # Z through L2
])
def test_bare_chain_kernel_matches_plain(dev, precision, left, n, vecs):
    rng = np.random.default_rng(5)
    z = rng.standard_normal((n, n))
    zs = torch.tensor(z + z.T, dtype=torch.float32, device=dev)
    v0 = torch.tensor(rng.standard_normal((vecs, n) if left else (n, vecs)),
                      dtype=torch.float32, device=dev)
    tk.reset_launch_counts()
    out = tk.bare_matvec_chain(zs, v0, 64, precision, left)
    assert tk.launch_counts()["bare_matvec_chain"] == 1
    ref = tk.bare_matvec_chain_plain(zs, v0, 64, precision, left)
    assert out.shape == v0.shape and bool(torch.all(torch.isfinite(out)))
    torch.testing.assert_close(out, ref, atol=K5_ATOL[precision], rtol=0)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("n,c,slices,cols,zs_shared", [
    (128, 1024, 1, 8, True),  # one CTA a group: the CTA's own barrier
    (128, 512, 2, 8, True),  # clusters of 2
    (128, 128, 8, 8, True),  # clusters of 8
    (128, 3, 8, 4, True),  # one ragged group of 4 columns
    (200, 12, 8, 8, True),  # a ragged last group of 8; slices of 28 rows
    (1000, 16, 8, 8, False),  # Z through L2
    (3615, 8, 8, 4, False),  # the former design's largest n at 8 columns: 4 columns, L2
])
def test_right_chain_plans_match_plain(dev, precision, n, c, slices, cols, zs_shared):
    """K5 right on every kind of plan the card's SM count gives at these
    shapes, on a symmetric Z as the roofline's (K5_ATOL's limits hold
    where the chain contracts its rounding differences; the rows of a
    non-symmetric Z are read in test_right_chain_few_passes): each cluster
    size the roofline's shapes use, ragged groups, Z through L2, in every
    precision; each run gives the same bits.  The limits are K5_ATOL's,
    set for unit columns of n = 1000 (entries ~1/sqrt(n)), scaled down with
    the entries for a larger n: x sqrt(1000 / n)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = tk.matvec_right_plan(n, c, sms, precision)
    assert (plan.slices, plan.cols, plan.zs_shared) == (slices, cols, zs_shared)
    rng = np.random.default_rng(11)
    z = rng.standard_normal((n, n))
    zs = torch.tensor(z + z.T, dtype=torch.float32, device=dev)
    v0 = torch.tensor(rng.standard_normal((n, c)), dtype=torch.float32, device=dev)
    iters = 64 if n <= 1000 else 8
    out = tk.bare_matvec_chain(zs, v0, iters, precision, False)
    ref = tk.bare_matvec_chain_plain(zs, v0, iters, precision, False)
    assert out.shape == v0.shape and bool(torch.all(torch.isfinite(out)))
    atol = K5_ATOL[precision] * min(1.0, (1000 / n) ** 0.5)
    torch.testing.assert_close(out, ref, atol=atol, rtol=0)
    assert torch.equal(out, tk.bare_matvec_chain(zs, v0, iters, precision, False))


def test_left_chain_above_the_resident_limit_matches_plain(dev):
    """n = 3000, above K5 left's resident limit: the card runs the right
    chain on the transposes (``left_chain_plan``).  Limit: K5_ATOL scaled
    to the entries of n = 3000, as in test_right_chain_plans_match_plain."""
    n = 3000
    assert not tk.left_chain_plan(16, n, _sms(dev))[0]
    rng = np.random.default_rng(13)
    z = rng.standard_normal((n, n))
    zs = torch.tensor(z + z.T, dtype=torch.float32, device=dev)
    v0 = torch.tensor(rng.standard_normal((16, n)), dtype=torch.float32, device=dev)
    tk.reset_launch_counts()
    out = tk.bare_matvec_chain(zs, v0, 8, "highest", True)
    assert tk.launch_counts()["bare_matvec_chain"] == 1
    ref = tk.bare_matvec_chain_plain(zs, v0, 8, "highest", True)
    assert out.shape == v0.shape and out.is_contiguous()
    torch.testing.assert_close(out, ref, atol=K5_ATOL["highest"] * (1000 / n) ** 0.5, rtol=0)


@pytest.mark.parametrize("n_iters", [0, 1, 2])
def test_right_chain_few_passes(dev, n_iters):
    """No pass returns v0 itself; one and two passes (no and one exchange
    of normalised v between the slices) match the plain version, on a
    non-symmetric Z across clusters of 8 row slices."""
    rng = np.random.default_rng(12)
    zs = torch.tensor(rng.standard_normal((128, 128)), dtype=torch.float32, device=dev)
    v0 = torch.tensor(rng.standard_normal((128, 128)), dtype=torch.float32, device=dev)
    out = tk.bare_matvec_chain(zs, v0, n_iters, "highest", False)
    ref = tk.bare_matvec_chain_plain(zs, v0, n_iters, "highest", False)
    if n_iters == 0:
        assert torch.equal(out, v0)
    torch.testing.assert_close(out, ref, atol=K5_ATOL["highest"], rtol=0)


@pytest.mark.parametrize("left,n,vecs", [(True, 1000, 16), (False, 128, 1024)])
def test_bare_chain_kernel_rounding_rules(dev, left, n, vecs):
    """One pass in each precision lies within ONE_PASS_REL of its own rule's
    plain version and beyond it from the other two rules'."""
    rng = np.random.default_rng(8)
    z = rng.standard_normal((n, n))
    zs = torch.tensor(z + z.T, dtype=torch.float32, device=dev)
    v0 = torch.tensor(rng.standard_normal((vecs, n) if left else (n, vecs)),
                      dtype=torch.float32, device=dev)
    plain = {p: tk.bare_matvec_chain_plain(zs, v0, 1, p, left) for p in K5_ATOL}
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double()))
    for p in K5_ATOL:
        out = tk.bare_matvec_chain(zs, v0, 1, p, left)
        for q, ref in plain.items():
            assert (rel(out, ref) <= ONE_PASS_REL) == (q == p), (p, q, rel(out, ref))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("r", [1, 16, 128])
@pytest.mark.parametrize("n", [250, 1000, 1001])
def test_left_chain_grid_matches_plain(dev, precision, r, n):
    """K5 left on its cooperative grid, 64 passes on a non-symmetric Z (v @ Z
    reads columns of Z as given): r = 128 cuts the rows of v into row
    groups, n = 1001 pads rows to 1004.  The limits are K5_ATOL's, set for
    unit rows of n = 1000 (entries ~1/sqrt(n)), scaled with the entries:
    x sqrt(1000 / n)."""
    rng = np.random.default_rng(9)
    zs = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
    v0 = torch.tensor(rng.standard_normal((r, n)), dtype=torch.float32, device=dev)
    tk.reset_launch_counts()
    out = tk.bare_matvec_chain(zs, v0, 64, precision, True)
    assert tk.launch_counts()["bare_matvec_chain"] == 1
    ref = tk.bare_matvec_chain_plain(zs, v0, 64, precision, True)
    assert out.shape == v0.shape and bool(torch.all(torch.isfinite(out)))
    torch.testing.assert_close(out, ref, atol=K5_ATOL[precision] * (1000 / n) ** 0.5, rtol=0)


def _left_on_plan(zs, v0, n_iters, precision, plan):
    """K5 left's launcher on a given plan (the wrapper takes the default
    one); raises on a CUDA error."""
    from riptrm_torch.ops import _build

    lib = _build.load()
    r, n = v0.shape
    out = torch.empty_like(v0)
    wbuf = torch.empty((2, r, -(-n // 4) * 4), dtype=torch.float32, device=v0.device)
    err = lib.matvec_chain_left_launch(
        *(tk._ptr(t) for t in (zs, v0, out, wbuf)), r, n, n_iters,
        tk.PRECISIONS[precision], plan.col_groups, plan.row_groups, plan.cols, plan.rows,
        plan.chunk, v0.device.index or 0, tk._stream(v0.device))
    _build.check(lib, err, "matvec_chain_left_launch")
    return out


def test_left_chain_grid_plans(dev):
    """Every row-group cut of the left chain, each reached through the
    default plan at a shape that selects it, gives the function, each run
    the same bits; a grid beyond co-residency is refused."""
    rng = np.random.default_rng(10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for r, n, groups in ((8, 1000, 1), (16, 1000, 2), (128, 1000, 4), (128, 1500, 2)):
        zs = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32, device=dev)
        v0 = torch.tensor(rng.standard_normal((r, n)), dtype=torch.float32, device=dev)
        ref = tk.bare_matvec_chain_plain(zs, v0, 16, "highest", True)
        plan = tk.matvec_left_plan(r, n, sms)
        assert plan.row_groups == groups
        out = _left_on_plan(zs, v0, 16, "highest", plan)
        torch.testing.assert_close(out, ref, atol=1e-5 * (1000 / n) ** 0.5, rtol=0)
        assert torch.equal(out, _left_on_plan(zs, v0, 16, "highest", plan))
    wide = tk.matvec_left_plan(*v0.shape, 100 * sms)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _left_on_plan(zs, v0, 16, "highest", wide)


def test_bare_chain_kernel_nonsymmetric_z(dev):
    rng = np.random.default_rng(6)
    z = torch.tensor(rng.standard_normal((96, 96)), dtype=torch.float32, device=dev)
    for left, shape in ((True, (4, 96)), (False, (96, 8))):
        v0 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
        torch.testing.assert_close(tk.bare_matvec_chain(z, v0, 16, "highest", left),
                                   tk.bare_matvec_chain_plain(z, v0, 16, "highest", left),
                                   atol=1e-4, rtol=0)


def _hbm_args(n, dev):
    p = _problem(n, dev)
    zs, xs, ws, _, _ = _lanes(p, 1)
    v0 = p.manifold.random_tangent(xs, torch.Generator(dev).manual_seed(2))[0]
    return zs, xs[0], ws[0], v0


@pytest.mark.parametrize("n", [200, 1000, 1001, 4000, 4001])
def test_hbm_chain_kernel_matches_plain(dev, n):
    """n = 4000: Zs is 64 MB, above the 50 MB L2, streamed by bulk copies;
    n = 1001 and 4001 (n % 4 != 0): the rows are not 16-byte aligned and
    the consumers load them themselves.  Limits as K1's."""
    args = _hbm_args(n, dev)
    tk.reset_launch_counts()
    out = tk.chained_barrier_matvec_hbm(*args, 64)
    assert tk.launch_counts()["chained_barrier_matvec_hbm"] == 1
    ref = tk.chained_barrier_matvec_plain(*args, 64)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)
    assert torch.equal(out, tk.chained_barrier_matvec_hbm(*args, 64))
    if n == 1000:  # K1's kernel computes the same function
        torch.testing.assert_close(out, tk.chained_barrier_matvec(*args, 64), atol=2e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("n_iters", [0, 1, 2])
def test_hbm_chain_kernel_few_iterations(dev, n_iters):
    """No iteration returns v0; one and two (the ring crossing one
    iteration boundary) match the plain version, at n = 4000."""
    args = _hbm_args(4000, dev)
    out = tk.chained_barrier_matvec_hbm(*args, n_iters)
    if n_iters == 0:
        assert torch.equal(out, args[3])
    ref = tk.chained_barrier_matvec_plain(*args, n_iters)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)


def _hbm_on_grid(zs, x, w, v0, n_iters, grid):
    """K6's launcher on a grid of ``grid`` CTAs (the wrapper always takes
    its plan's, one CTA per SM); raises on a CUDA error."""
    from riptrm_torch.ops import _build

    lib = _build.load()
    n = x.shape[0]
    plan = tk.chain_hbm_plan(n)
    corr = tk.barrier_corr(zs, x[None], w[None]).contiguous()
    u, out = torch.empty(2 * n, dtype=torch.float32, device=x.device), torch.empty_like(x)
    bar, claims = (torch.zeros(k, dtype=torch.int32, device=x.device) for k in (1, n_iters))
    err = lib.chain_hbm_launch(
        *(tk._ptr(t) for t in (zs, x, w, v0, corr, u, bar, claims, out)), n, n_iters, grid,
        plan.pieces, plan.piece, plan.stages, int(plan.xw_shared), x.device.index or 0,
        tk._stream(x.device))
    _build.check(lib, err, "chain_hbm_launch")
    return out


def test_hbm_chain_kernel_grids(dev):
    """Any grid up to one CTA per row gives the function, each run the same
    bits (whichever CTA claims a row computes its dot product in the same
    order); a grid of more CTAs than rows is refused."""
    args = _hbm_args(1000, dev)
    ref = tk.chained_barrier_matvec_plain(*args, 16)
    for grid in (1, 3, 64, 132):
        out = _hbm_on_grid(*args, 16, grid)
        torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)
        assert torch.equal(out, _hbm_on_grid(*args, 16, grid))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _hbm_on_grid(*args, 16, 1_000_000)


@pytest.mark.parametrize("method", ["eigh", "ms"])
def test_exact_step_on_card_matches_cpu(dev, method):
    """Exact mode's step (cuSOLVER's eigh or Cholesky in place of LAPACK's)
    on the golden NonnegPCA point, float64: the card's new state and info
    against the CPU's, rtol 1e-9 (eigenvectors up to their signs)."""
    from riptrm_torch.solvers import riptrm as trm

    opt = RIPTRM({"exact_trs_method": method, "checkTRSoptimality": True}).option
    out = {}
    for d in ("cpu", dev):
        p = nonneg_pca.load_problem("dataset/NonnegPCA/1", "a", dtype=torch.float64, device=d)
        st, info = trm.make_step(p, opt)(trm.init_state(p, opt))
        out[str(d)] = (trm.state_to_numpy(st), {k: v.cpu().numpy() for k, v in info.items()})
    (s_cpu, i_cpu), (s_dev, i_dev) = out["cpu"], out[str(dev)]
    for k, v in i_cpu.items():
        atol = 1e-11 if k in ("TRS_KKTresid", "TRS_compl") else 1e-15
        np.testing.assert_allclose(i_dev[k], v, rtol=1e-9, atol=atol, err_msg=k)
    for k, v in s_cpu.items():
        got = np.abs(s_dev[k]) if (method, k) == ("eigh", "h_q") else s_dev[k]
        want = np.abs(v) if (method, k) == ("eigh", "h_q") else v
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12, err_msg=k)


BASELINE_STEPS = {
    "RIPM dense": ("ripm", {"checkNTequation": True}),
    "RIPM Krylov": ("ripm", {"KrylovIterMethod": True}),
    "RIPM jacobi_theta": ("ripm", {"KrylovIterMethod": True,
                                   "KrylovPreconditioner": "jacobi_theta"}),
    "RSQO reghess chol": ("rsqo", {"quadoptim_eigvalcorr": 1e-2}),
    "RSQO reghess_shift schulz": ("rsqo", {"quadoptim_type": "reghess_shift",
                                           "quadoptim_linear_solver": "schulz"}),
    "RALM": ("ralm", {}),
}


@pytest.mark.parametrize("case", BASELINE_STEPS)
def test_baseline_step_on_card_matches_cpu(dev, case):
    """One step of RIPM, RSQO or RALM (cuSOLVER's solve, eigh, Cholesky
    and cuBLAS's products in place of LAPACK's and the CPU's) on the golden
    NonnegPCA point, float64: the card's new state against the CPU's, rtol
    1e-8, and nothing of the step on the CPU."""
    import importlib

    module_name, extra = BASELINE_STEPS[case]
    mod = importlib.import_module(f"riptrm_torch.solvers.{module_name}")
    solver = {"ripm": "RIPM", "rsqo": "RSQO", "ralm": "RALM"}[module_name]
    opt = getattr(mod, solver)(extra).option
    out = {}
    for d in ("cpu", dev):
        p = nonneg_pca.load_problem("dataset/NonnegPCA/1", "a", dtype=torch.float64, device=d)
        if module_name == "ripm":
            st0, t1, t2 = mod.init_state(p, opt)
            st, _ = mod.make_step(p, opt)(st0, t1, t2)
        else:
            st, _ = mod.make_step(p, opt)(mod.init_state(p, opt))
        if d != "cpu":
            assert all(getattr(st, f).device.type == "cuda" for f in st.__dataclass_fields__)
        out[str(d)] = mod.state_to_numpy(st)
    for k, v in out["cpu"].items():
        if v is not None:
            np.testing.assert_allclose(out[str(dev)][k], v, rtol=1e-8, atol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# The families without a kernel: one RIPTRM step on the card against the
# same step on the CPU, float64, rtol 1e-8 (cuSOLVER's Cholesky, SVD and QR
# against LAPACK's, a few flops deep)
# ---------------------------------------------------------------------------
def _family(name, device):
    from riptrm_torch.problems import low_rank, rosenbrock, stable_identification

    kw = dict(dtype=torch.float64, device=device)
    if name == "sid":
        return stable_identification.load_problem("dataset/StableIdentification/1", "a", **kw)
    if name == "rosenbrock":
        return rosenbrock.make_problem(5, 3, **kw)
    return low_rank.load_problem("dataset/LowRank/1", "a", **kw)


@pytest.mark.parametrize("name,mode", [("sid", "tCG"), ("sid", "Exact_RepMat"),
                                       ("rosenbrock", "tCG"), ("rosenbrock", "Exact_RepMat"),
                                       ("lowrank", "tCG")])
def test_new_family_step_on_card_matches_cpu(dev, name, mode):
    from riptrm_torch.solvers import riptrm

    option = RIPTRM({"TRS_solver": mode, "second_order_stationarity": False}).option
    out = {}
    for device in ("cpu", dev):
        problem = _family(name, device)
        state = riptrm.init_state(problem, option)
        step = riptrm.make_step(problem, option)
        for _ in range(3):
            state, info = step(state)
        out[str(device)] = (problem, state, info)
    (pc, sc, ic), (pg, sg, ig) = out["cpu"], out[str(dev)]
    man = pc.manifold
    if hasattr(man, "embed_point"):  # the factors carry the SVD's signs
        np.testing.assert_allclose(man.embed_point(sg.x).cpu().numpy(),
                                   man.embed_point(sc.x).numpy(), rtol=1e-8, atol=1e-12)
    else:
        np.testing.assert_allclose(sg.x.cpu().numpy(), sc.x.numpy(), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(sg.y.cpu().numpy(), sc.y.numpy(), rtol=1e-8, atol=1e-12)
    for key in ("residual", "cost", "normdx"):
        np.testing.assert_allclose(float(ig[key][0]), float(ic[key][0]), rtol=1e-8, err_msg=key)


def _instances(b, n, dev, seed=3):
    """B spiked Z [B, n, n] and feasible starts [B, n] from numpy, float32."""
    rng = np.random.default_rng(seed)
    zs = []
    for _ in range(b):
        v = (rng.permutation(n) < int(0.7 * n)) / np.sqrt(int(0.7 * n))
        zs.append(np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((n, n)) / np.sqrt(n))
    xs = np.abs(rng.standard_normal((b, n)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    kw = dict(dtype=torch.float32, device=dev)
    return torch.tensor(np.stack(zs), **kw), torch.tensor(xs, **kw)


def test_per_lane_zs_runs_k2_once_a_lane(dev):
    """Instance batching on the sphere: a [B, n, n] Zs takes K2 once a lane
    (K3 never), each launch against its plain version at the K2 bounds."""
    from riptrm_torch.parallel.sweep import init_state_from
    from riptrm_torch.solvers import riptrm

    b, n = 3, 250
    zs, xs = _instances(b, n, dev)
    p = nonneg_pca.make_problem(zs, xs)
    opt = RIPTRM({"TRS_solver": "tCG", "second_order_stationarity": False,
                  "use_fused_tcg": True}).option
    st = init_state_from(p, opt, xs, torch.ones_like(xs))
    tk.reset_launch_counts()
    riptrm.make_step(p, opt)(st)
    counts = tk.launch_counts()
    assert counts["fused_tcg_sphere_quadratic"] == b
    assert counts["fused_tcg_sphere_quadratic_batched"] == 0
    c, _, cx = _barrier_ops(p, st.x, st.y, st.mu)
    for i in range(b):
        args = (p.structure["Zs"][i], st.x[i:i + 1], (st.y / c)[i:i + 1], cx[i:i + 1],
                st.tr_radius[i:i + 1])
        eta, heta, it, code = tk.fused_tcg_sphere_quadratic(
            args[0], args[1][0], args[2][0], args[3][0], args[4][0], maxinner=n - 1)
        e_p, h_p, it_p, code_p = tk.fused_tcg_plain(*args, maxinner=n - 1)
        assert (int(it), int(code)) == (int(it_p[0]), int(code_p[0]))
        torch.testing.assert_close(eta, e_p[0], atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(heta, h_p[0], atol=2e-4, rtol=1e-3)


def test_per_lane_zs_runs_the_stiefel_kernel_at_one_lane(dev, monkeypatch):
    """Instance batching on St(128, 8): a [B, n, n] Zs launches the Stiefel
    kernel once a lane at B = 1 (never with B lanes), each launch against
    its plain version at the Stiefel bounds."""
    from riptrm_torch.parallel.sweep import init_state_from
    from riptrm_torch.solvers import riptrm

    b, n, p_ = 3, 128, 8
    zs, _ = _instances(b, n, dev)
    gen = torch.Generator().manual_seed(4)
    frames = torch.stack([bounded_pca.generate_initialpoint(gen, n, p_, dtype=torch.float32,
                                                            device="cpu")
                          for _ in range(b)]).to(dev)
    prob = bounded_pca.make_problem(zs, frames)
    opt = RIPTRM({"TRS_solver": "tCG", "second_order_stationarity": False,
                  "use_fused_tcg": True}).option
    st = init_state_from(prob, opt, frames, torch.ones(b, prob.num_ineq, dtype=torch.float32,
                                                       device=dev))
    widths = []
    launch = tk._launch_stiefel

    def spy(zs_, d, xs, *rest):
        widths.append(xs.shape[0])
        return launch(zs_, d, xs, *rest)

    monkeypatch.setattr(tk, "_launch_stiefel", spy)
    tk.reset_launch_counts()
    riptrm.make_step(prob, opt)(st)
    assert widths == [1] * b
    assert tk.launch_counts()["fused_tcg_stiefel_bound_batched"] == b
    c, _, cx = _barrier_ops(prob, st.x, st.y, st.mu)
    d = prob.structure["d"]
    for i in range(b):
        zi = prob.structure["Zs"][i]
        ws, ss = tk.stiefel_bound_pieces(zi, d, st.x[i:i + 1], st.y[i:i + 1], c[i:i + 1])
        args = (zi, d, st.x[i:i + 1], ws, ss, cx[i:i + 1], st.tr_radius[i:i + 1])
        dim = prob.manifold.dim
        etas, hetas, iters, codes = tk.fused_tcg_stiefel_bound_batched(*args, maxinner=dim)
        e_p, h_p, it_p, code_p = tk.fused_tcg_stiefel_bound_plain(*args, maxinner=dim)
        assert iters.tolist() == it_p.tolist() and codes.tolist() == code_p.tolist()
        torch.testing.assert_close(etas, e_p, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(hetas, h_p, atol=1e-4, rtol=1e-3)


def test_tf32_scoped_problem_matches_fp32_within_tf32_bound(dev):
    """A matmul_precision='high' problem's gradient (TF32 inside its scope)
    against the 'highest' problem's, elementwise within TF32's bound: the
    inputs rounded to a 10-bit mantissa (2 x 2^-11 relative) and float32
    accumulation (n x 2^-24), times 2 |Zs| |x|; the process's setting is as
    it was after the call."""
    n, b = 1000, 4
    zs, xs = _instances(1, n, dev)
    xs = xs.expand(b, n).contiguous()
    before = torch.get_float32_matmul_precision()
    hi = nonneg_pca.make_problem(zs[0], xs[0], matmul_precision="high")
    full = nonneg_pca.make_problem(zs[0], xs[0], matmul_precision="highest")
    g_hi, g_full = hi.egrad(xs), full.egrad(xs)
    assert torch.get_float32_matmul_precision() == before
    bound = (2 * 2.0**-11 + n * 2.0**-24) * 2.0 * (xs.abs() @ full.structure["Zs"].abs())
    assert bool(((g_hi - g_full).abs() <= bound).all())


def test_world_one_nccl_sharded_solve_launches_k3(dev, tmp_path):
    """``sharded_riptrm_solve`` in a one-rank NCCL group at n = 1000, B = 16,
    fused: K3 launches, and the rank's lanes are ``batched_riptrm_solve``'s
    bit for bit (the same computation), the residuals gathered to [16]."""
    import torch.distributed as dist

    from riptrm_torch.parallel import distributed, sweep

    n, b = 1000, 16
    p = _problem(n, dev)
    rng = np.random.default_rng(3)
    xs = np.abs(rng.standard_normal((b, n)))
    xs = torch.tensor(xs / np.linalg.norm(xs, axis=1, keepdims=True), dtype=torch.float32,
                      device=dev)
    ys = torch.ones(b, n, dtype=torch.float32, device=dev)
    option = {"maxiter": 60, "tolresid": 3e-4, "TRS_solver": "tCG",
              "second_order_stationarity": False, "use_fused_tcg": True,
              "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
              "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-4)}
    distributed.initialize(f"file://{tmp_path / 'rv'}", 1, 0)
    try:
        mesh = sweep.make_mesh({"dp": 1})
        tk.reset_launch_counts()
        x, y, ks, res = sweep.sharded_riptrm_solve(p, option, 100, mesh)(xs, ys)
        assert tk.launch_counts()["fused_tcg_sphere_quadratic_batched"] > 0
    finally:
        dist.destroy_process_group()
    st, ks1, res1 = sweep.batched_riptrm_solve(p, option, 100)(xs, ys)
    assert res.shape == (b,)
    assert torch.equal(x, st.x) and torch.equal(ks, ks1) and torch.equal(res, res1)


def test_exported_sweep_reloaded_on_card_launches_k3(dev, tmp_path):
    """A fused NonnegPCA sweep exported on the card and loaded back runs its
    tCG through K3 (counted by the operator's CUDA implementation at run
    time), and its solutions agree with the direct sweep's in float32."""
    from riptrm_torch.experiment.export_artifact import export_sweep, load_sweep
    from riptrm_torch.parallel.sweep import batched_solver_sweep

    problem = _problem(256, dev)
    b = 8
    rng = np.random.default_rng(5)
    xs = np.abs(rng.standard_normal((b, 256)))
    xs = torch.tensor(xs / np.linalg.norm(xs, axis=1, keepdims=True), dtype=torch.float32,
                      device=dev)
    ys = torch.ones(b, 256, dtype=torch.float32, device=dev)
    option = {"maxiter": 60, "tolresid": 3e-4, "TRS_solver": "tCG",
              "second_order_stationarity": False, "use_fused_tcg": True,
              "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
              "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-4)}
    path = str(tmp_path / "k3.pt2")
    tk.reset_launch_counts()
    export_sweep(problem, "RIPTRM", option, path, batch=b, max_steps=300, device=dev)
    assert not any(tk.launch_counts().values())  # tracing launches nothing
    run, manifest = load_sweep(path)
    assert manifest["device"] == str(problem.x0.device)
    x, _, _, res = run(xs, ys)
    assert tk.launch_counts()["fused_tcg_sphere_quadratic_batched"] > 0
    _, _, _, res_d = batched_solver_sweep(problem, "RIPTRM", option, 300)(xs, ys)
    assert torch.isfinite(res).all()
    assert float(res.median()) <= 10 * max(float(res_d.median()), 3e-4)


def _dense_systems(n, b, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n)) / np.sqrt(n) + np.eye(n)
    rhs = rng.standard_normal((b, n))
    return (torch.tensor(a, dtype=torch.float32, device=dev),
            torch.tensor(rhs, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("n", [1, 2, 12, 31, 32, 33, 49, 64])
@pytest.mark.parametrize("b", [1, 5, 1000])
def test_dense_solve_kernel_matches_plain(dev, n, b):
    """The dense-solve kernel against its plain version on the card: one
    launch, the same pivots, so the same answer up to FMA rounding (the
    kernel fuses the rank-1 update, the plain version rounds the product):
    relative error within 8 n eps cond of each other."""
    a, rhs = _dense_systems(n, b, dev, seed=n + b)
    tk.reset_launch_counts()
    x = tk.dense_solve_nan(a, rhs)
    torch.cuda.synchronize()
    assert tk.launch_counts()["dense_solve_nan"] == 1
    ref = tk.dense_solve_plain(a, rhs)
    rel = torch.linalg.vector_norm(x - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
    cond = torch.linalg.cond(a.double().cpu()).float().to(dev)
    assert torch.all(rel <= 8 * n * torch.finfo(torch.float32).eps * cond), rel.max()


def test_dense_solve_kernel_ties_and_lanes(dev):
    """Ties: the two systems of ``test_torch_dense_solve.tie_systems``,
    whose answers tell the lower position's pivot from the other by one
    rounding, read LAPACK's answers bit for bit.  +-1 matrices (ties in
    every column, exact arithmetic at n = 4): the kernel equals the plain
    version bit for bit, NaN where the plain version meets a zero pivot; a
    lane reads the same alone, in the batch and at another place in it."""
    from test_torch_dense_solve import tie_systems

    for a, rhs, want, _ in tie_systems():
        assert torch.equal(tk.dense_solve_nan(a.to(dev), rhs.to(dev)).cpu(), want)
    g = torch.Generator().manual_seed(9)
    a = (torch.randint(0, 2, (4096, 4, 4), generator=g) * 2 - 1).float().to(dev)
    rhs = (torch.randint(0, 2, (4096, 4), generator=g) * 2 - 1).float().to(dev)
    x = tk.dense_solve_nan(a, rhs)
    ref = tk.dense_solve_plain(a, rhs)
    assert torch.equal(torch.isnan(x), torch.isnan(ref)) and torch.isnan(x).any()
    assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(ref))
    a, rhs = _dense_systems(49, 333, dev, seed=3)
    x = tk.dense_solve_nan(a, rhs)
    perm = torch.randperm(333, generator=g).to(dev)
    assert torch.equal(tk.dense_solve_nan(a[perm], rhs[perm]), x[perm])
    for i in (0, 101, 332):
        assert torch.equal(tk.dense_solve_nan(a[i:i + 1], rhs[i:i + 1])[0], x[i])


def test_dense_solve_kernel_nan_lanes(dev):
    """An exact zero pivot (two equal rows) or a NaN in the input: that lane
    reads NaN whole, its neighbours what they read alone."""
    a, rhs = _dense_systems(49, 4, dev, seed=4)
    a[1, 30] = a[1, 3]
    a[2, 7, 7] = float("nan")
    x = tk.dense_solve_nan(a, rhs)
    assert torch.isnan(x[1]).all() and torch.isnan(x[2]).all()
    for i in (0, 3):
        assert torch.equal(x[i], tk.dense_solve_nan(a[i:i + 1], rhs[i:i + 1])[0])


def test_dense_solve_kernel_reads_column_major(dev):
    """A column-major batch (RIPM's symmetrised materialisation) is read in
    place, with no copy, and gives the row-major batch's answer bit for
    bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    a, rhs = _dense_systems(49, 300, dev, seed=6)
    cm = a.mT.contiguous().mT
    assert not cm.is_contiguous() and torch.equal(cm, a)
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops():
        x = tk.dense_solve_nan(cm, rhs)
    assert not [f for f in seen if "copy" in f or "clone" in f], seen
    assert torch.equal(x, tk.dense_solve_nan(a, rhs))


def test_dense_solve_library_routes_launch_nothing(dev):
    """float64 and n above the limit take torch.linalg.solve_ex on the card:
    no launch."""
    a, rhs = _dense_systems(tk.DENSE_SOLVE_MAX_N + 1, 3, dev)
    tk.reset_launch_counts()
    x = tk.dense_solve_nan(a, rhs)
    x64 = tk.dense_solve_nan(a[:, :12, :12].double(), rhs[:, :12].double())
    assert tk.launch_counts()["dense_solve_nan"] == 0
    assert x.dtype == torch.float32 and x64.dtype == torch.float64
    assert torch.equal(x, torch.linalg.solve(a, rhs))


@pytest.mark.parametrize("n", [12, 50])
def test_ripm_float32_sweep_on_card_matches_cpu(dev, n):
    """float32 dense RIPM from 64 starts with the benchmark cell's options
    (``tests/test_torch_ripm.py::test_float32_dense_sweep_matches_jax``'s
    recipe): on the card the dense-solve kernel launches once a lockstep
    step; steps lane by lane equal the CPU sweep's (the kernel's plain
    version), every residual under tolresid, each within the benchmark
    cell's resid_gap limit (1e-2 of max(its, tolresid)) of the CPU's and
    each answer within 1e-5."""
    from riptrm_torch.parallel.sweep import batched_solver_sweep

    rng = np.random.default_rng(0)
    size = int(0.7 * n)
    v = (rng.permutation(n) < size) / np.sqrt(size)
    noise = rng.standard_normal((n, n)) / np.sqrt(n)
    np.fill_diagonal(noise, rng.standard_normal(n) * 2.0 / np.sqrt(n))
    z = np.sqrt(0.5) * np.outer(v, v) + noise
    xs = rng.random((64, n))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    option = {"maxiter": 60, "tolresid": 3e-4, "sweep_stall_window": 25}
    runs = []
    for device in (dev, torch.device("cpu")):
        problem = nonneg_pca.make_problem(z, xs[0], dtype=torch.float32, device=device,
                                          matmul_precision="highest")
        tk.reset_launch_counts()
        x, _, ks, res = batched_solver_sweep(problem, "RIPM", option, 60)(
            torch.tensor(xs, dtype=torch.float32, device=device),
            torch.ones(64, n, device=device))
        runs.append((x.cpu(), ks.cpu(), res.cpu(), tk.launch_counts()["dense_solve_nan"]))
    (x, ks, res, launches), (x_c, ks_c, res_c, launches_c) = runs
    assert launches == int(ks.max()) > 0 and launches_c == 0
    assert ks.tolist() == ks_c.tolist()
    assert torch.all(res <= option["tolresid"]) and torch.all(res_c <= option["tolresid"])
    gap = (res - res_c).abs() / torch.clamp(res_c, min=option["tolresid"])
    assert float(gap.max()) <= 1e-2, gap.max()
    assert float((x - x_c).abs().max()) <= 1e-5


def _sid_lanes(b, dev, d=5, seed=0):
    """StableIdentification on the card, float32: the shipped instance
    (d = 5, m = 16) or one of random data at width d (2 d + 1 constraints),
    b lanes around its start
    (each moved along a random tangent), multipliers in [0.5, 1.5], a random
    direction; the operator's inputs (x, g, y, c, dx) and keywords."""
    from riptrm_torch.problems import stable_identification as si

    if d == 5:
        problem = si.load_problem("dataset/StableIdentification/1", "a", dtype=torch.float32,
                                  device=dev)
    else:
        # a box on entry (i, 2i mod d) of each row, and a twobox row on the
        # last row's entry: two kinds on one entry
        rng = np.random.default_rng(seed)
        constset = [[0, i, 2 * i % d, -10.0, 10.0] for i in range(d)]
        constset.append([2, d - 1, 2 * (d - 1) % d, 0.0, 0.1])
        problem = si.make_problem(d, [rng.standard_normal((d, 20))], np.asarray(constset),
                                  (np.zeros((d, d)), np.eye(d), np.eye(d)),
                                  dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    man = problem.manifold
    x = problem.x0.expand((b,) + problem.x0.shape).clone()

    def tangent():  # Skew(1) has no unit tangent: projected normals
        return man.proj(x, torch.randn(x.shape, generator=gen, device=dev))

    x = man.retract(x, 0.05 * tangent())
    y = 0.5 + torch.rand(b, problem.num_ineq, generator=gen, device=dev)
    der = problem.derivatives
    kw = dict(gram=der.gram, idx=der.idx, lin=der.lin, two=der.two, p1=der.p1, scale=der.scale)
    return (x, der.egrad(x, y)[3], y, problem.slack(x), tangent()), kw


def _hvp_errors(args, kw):
    """(K8's image, its plain version's, each lane's error of both against
    the float64 image of the same inputs over the lane's largest |entry|)."""
    from riptrm_torch.problems.stable_identification import barrier_hvp_plain

    consts = [kw[k] for k in ("gram", "idx", "lin", "two", "p1")]
    out = tk.stableid_barrier_hvp(*args, **kw)
    plain = barrier_hvp_plain(*args, *consts, kw["scale"])
    truth = barrier_hvp_plain(*(t.double() for t in args), consts[0].double(), consts[1],
                              *(t.double() for t in consts[2:]), kw["scale"])

    def lane(v):
        return v.abs().flatten(1).amax(dim=1)

    mag = lane(truth)
    return out, plain, lane(out.double() - truth) / mag, lane(plain.double() - truth) / mag


# K8 against the float64 image of the same float32 inputs, each lane's error
# over its largest |entry|: over the lanes, the median and the 99th
# percentile may be at most HVP_SPREAD times the plain version's, the worst
# lane HVP_WORST times the plain version's worst.  Both are the same FP32
# products with their sums of d terms in another order; the worst lanes are
# those whose image cancels most, where two orders part by several times
# (the card read 1.1x at the median, 1.04x at 99 % and 1.1-2.7x at the worst
# lane, PERF.md).
HVP_SPREAD, HVP_WORST = 2.0, 8.0


def _within_plain(err, err_plain):
    q = torch.tensor([0.5, 0.99], dtype=err.dtype, device=err.device)
    return bool((torch.quantile(err, q) <= HVP_SPREAD * torch.quantile(err_plain, q)).all()
                and err.max() <= HVP_WORST * err_plain.max())


@pytest.mark.parametrize("b", [131072, 1000])
def test_stableid_hvp_kernel_matches_plain(dev, b):
    """K8 against its plain version at the benchmark cell's shapes (d = 5,
    m = 16, B = 131072) and at a B that is no multiple of a block's 24
    lanes: one launch, every lane finite, the lanes' errors against float64
    within HVP_SPREAD and HVP_WORST of the plain version's."""
    args, kw = _sid_lanes(b, dev)
    tk.reset_launch_counts()
    out, _, err, err_plain = _hvp_errors(args, kw)
    torch.cuda.synchronize()
    assert tk.launch_counts()["stableid_barrier_hvp"] == 1
    assert torch.isfinite(out).all()
    assert _within_plain(err, err_plain), (err.max(), err_plain.max())


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 7, 8])
def test_stableid_hvp_kernel_widths(dev, d):
    """K8 at every other width its plan takes (instances of random data,
    B = 777): within the same bound."""
    args, kw = _sid_lanes(777, dev, d=d, seed=d)
    out, _, err, err_plain = _hvp_errors(args, kw)
    assert torch.isfinite(out).all()
    assert _within_plain(err, err_plain), (d, err.max(), err_plain.max())


def test_stableid_hvp_kernel_lanes_and_nan(dev):
    """A lane reads the same bits alone, in the batch, at another place in
    it and in a batch of 1001 lanes; a NaN in a lane's point makes that
    lane NaN whole and leaves the others as they were."""
    args, kw = _sid_lanes(1001, dev, seed=3)
    out = tk.stableid_barrier_hvp(*args, **kw)
    perm = torch.randperm(1001, device=dev)
    assert torch.equal(tk.stableid_barrier_hvp(*(t[perm] for t in args), **kw), out[perm])
    for i in (0, 500, 1000):
        assert torch.equal(tk.stableid_barrier_hvp(*(t[i:i + 1] for t in args), **kw)[0], out[i])
    x = args[0].clone()
    x[11, 2, 0, 4] = float("nan")
    x[12] = float("nan")
    bad = tk.stableid_barrier_hvp(x, *args[1:], **kw)
    rest = torch.ones(1001, dtype=torch.bool, device=dev)
    rest[11:13] = False
    assert torch.isnan(bad[11:13]).all() and torch.equal(bad[rest], out[rest])


def test_stableid_sweep_launches_k8_once_a_product(dev):
    """The benchmark cell's RIPTRM tCG options on the shipped instance,
    float32, from its 20 starts for 4 lockstep steps: K8 launches once for
    every product the tCG asks for; float64 launches nothing."""
    from riptrm_torch.parallel.sweep import batched_riptrm_solve
    from riptrm_torch.problems import stable_identification as si
    from riptrm_torch.solvers import riptrm

    option = {"maxiter": 60, "tolresid": 1e-3, "TRS_solver": "tCG",
              "second_order_stationarity": False}
    starts = "abcdefghijklmnopqrst"
    barrier_ops = riptrm._barrier_ops
    for dtype in (torch.float32, torch.float64):
        problems = [si.load_problem("dataset/StableIdentification/1", s, dtype=dtype, device=dev)
                    for s in starts]
        xs = torch.stack([p.x0 for p in problems])
        ys = torch.ones(len(starts), problems[0].num_ineq, dtype=dtype, device=dev)
        products = [0]

        def counted(*args):
            c, hw, cx = barrier_ops(*args)

            def hw_counted(dx):
                products[0] += 1
                return hw(dx)

            return c, hw_counted, cx

        tk.reset_launch_counts()
        riptrm._barrier_ops = counted
        try:
            _, k, res = batched_riptrm_solve(problems[0], option, 4)(xs, ys)
        finally:
            riptrm._barrier_ops = barrier_ops
        launches = tk.launch_counts()["stableid_barrier_hvp"]
        assert int(k.max()) == 4 and torch.isfinite(res).all()
        assert launches == (products[0] if dtype == torch.float32 else 0) and products[0] > 0


def _spd_systems(b, dev, d=5, seed=0):
    """The SPD metric's solves as Product's inner product passes them: the
    factor of b stacked pairs of d x d SPD points (``spd._chol``'s,
    column-major) and the SPD blocks of a packed [b, 3, d, d] tangent, a
    narrowed view."""
    from riptrm_torch.manifolds import spd

    gen = torch.Generator(dev).manual_seed(seed)
    x = spd.SymmetricPositiveDefinite(d).random_point(gen, 2 * b, dtype=torch.float32,
                                                      device=dev)
    v = torch.randn((b, 3, d, d), generator=gen, device=dev)
    return spd._chol(x.unflatten(0, (b, 2))), (v + v.mT).narrow(1, 1, 2)


def _solve_errors(l, u):
    """(K9's solve, each system's error of K9 and of the plain version
    against the float64 solve over the system's largest |entry|)."""
    out = tk.spd_cho_solve(l, u)
    plain = tk.spd_cho_solve_plain(l, u)
    truth = tk.spd_cho_solve_plain(l.double(), u.double())

    def system(v):
        return v.abs().flatten(-2).amax(dim=-1).flatten()

    mag = system(truth)
    return out, system(out.double() - truth) / mag, system(plain.double() - truth) / mag


@pytest.mark.parametrize("b", [131072, 1001])
def test_spd_solve_kernel_matches_plain(dev, b):
    """K9 at the benchmark cell's systems ([131072, 2, 5, 5], u read in place
    from a packed tangent) and at a batch that is no multiple of a block's
    51 systems: one launch, every system finite, the systems' errors
    against float64 within HVP_SPREAD and HVP_WORST of the plain version's
    (K8's rule: the same FP32 operations, fused or not)."""
    l, u = _spd_systems(b, dev)
    tk.reset_launch_counts()
    out, err, err_plain = _solve_errors(l, u)
    torch.cuda.synchronize()
    assert tk.launch_counts()["spd_cho_solve"] == 1
    assert out.is_contiguous() and torch.isfinite(out).all()
    assert _within_plain(err, err_plain), (err.max(), err_plain.max())


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 7, 8])
def test_spd_solve_kernel_widths(dev, d):
    """K9 at every other width its plan takes (B = 777): within the same
    bound."""
    l, u = _spd_systems(777, dev, d=d, seed=d)
    out, err, err_plain = _solve_errors(l, u)
    assert torch.isfinite(out).all()
    assert _within_plain(err, err_plain), (d, err.max(), err_plain.max())


def test_spd_solve_kernel_layouts_lanes_and_nan(dev):
    """A system reads the same bits from contiguous inputs, from row- or
    column-major ones, from three leading axes that no two strides merge,
    alone, and at another place in the batch; a NaN factor makes its system
    NaN whole and leaves the others as they were; an empty batch launches
    nothing."""
    l, u = _spd_systems(1001, dev, seed=3)
    out = tk.spd_cho_solve(l, u)
    lc, uc = l.contiguous(), u.contiguous()
    assert torch.equal(tk.spd_cho_solve(lc, uc), out)
    assert torch.equal(tk.spd_cho_solve(lc, uc.mT.contiguous().mT), out)
    # 1001 lanes as [13, 11, 7]: the factor's axes reversed, so no two merge
    l3 = lc.reshape(7, 11, 13, 2, 5, 5).permute(2, 1, 0, 3, 4, 5)
    u3 = uc.reshape(13, 11, 7, 2, 5, 5)
    assert torch.equal(tk.spd_cho_solve(l3, u3),
                       tk.spd_cho_solve(l3.contiguous(), u3.contiguous()))
    perm = torch.randperm(1001, device=dev)
    assert torch.equal(tk.spd_cho_solve(l[perm], u[perm]), out[perm])
    for i in (0, 500, 1000):
        assert torch.equal(tk.spd_cho_solve(l[i:i + 1], u[i:i + 1]), out[i:i + 1])
    bad = l.clone()
    bad[11, 1] = float("nan")
    nan_out = tk.spd_cho_solve(bad, u)
    rest = torch.ones(1001, 2, dtype=torch.bool, device=dev)
    rest[11, 1] = False
    assert torch.isnan(nan_out[11, 1]).all() and torch.equal(nan_out[rest], out[rest])
    tk.reset_launch_counts()
    assert tk.spd_cho_solve(l[:0], u[:0]).shape == (0, 2, 5, 5)
    assert tk.launch_counts()["spd_cho_solve"] == 0


def test_stableid_sweep_launches_k9_once_a_metric_solve(dev):
    """The benchmark cell's RIPTRM tCG options on the shipped instance from
    its 20 starts for 4 lockstep steps: K9 launches once for every solve of
    the SPD metric in float32, never in float64."""
    from riptrm_torch.manifolds import spd
    from riptrm_torch.parallel.sweep import batched_riptrm_solve
    from riptrm_torch.problems import stable_identification as si

    option = {"maxiter": 60, "tolresid": 1e-3, "TRS_solver": "tCG",
              "second_order_stationarity": False}
    starts = "abcdefghijklmnopqrst"
    cho_solve = spd._cho_solve
    for dtype in (torch.float32, torch.float64):
        problems = [si.load_problem("dataset/StableIdentification/1", s, dtype=dtype, device=dev)
                    for s in starts]
        xs = torch.stack([p.x0 for p in problems])
        ys = torch.ones(len(starts), problems[0].num_ineq, dtype=dtype, device=dev)
        solves = [0]

        def counted(l, u):
            solves[0] += 1
            return cho_solve(l, u)

        tk.reset_launch_counts()
        spd._cho_solve = counted
        try:
            _, k, res = batched_riptrm_solve(problems[0], option, 4)(xs, ys)
        finally:
            spd._cho_solve = cho_solve
        launches = tk.launch_counts()["spd_cho_solve"]
        assert int(k.max()) == 4 and torch.isfinite(res).all()
        assert launches == (solves[0] if dtype == torch.float32 else 0) and solves[0] > 0

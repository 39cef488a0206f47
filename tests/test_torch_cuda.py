"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked ``cuda``: each test skips where CUDA is absent.  No JAX import, so
the file runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs come from numpy with a seed: a spiked Z, strictly feasible starts
and barrier weights as the solver builds them.  float32; tolerances of
the CPU parity suite (K1 atol 2e-4; K2/K3 atol 2e-4, rtol 1e-3) with
iteration counts and stop codes equal.
"""

import numpy as np
import pytest
import torch

from riptrm_torch.ops import kernels as tk
from riptrm_torch.problems import nonneg_pca
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


@pytest.mark.parametrize("n", [64, 250, 1001])
def test_chain_kernel_matches_plain(dev, n):
    """n = 1001 takes the kernel's scalar (not float4) matvec path."""
    p = _problem(n, dev)
    zs, xs, ws, _, _ = _lanes(p, 1)
    v0 = p.manifold.random_tangent(xs, torch.Generator(dev).manual_seed(2))[0]
    tk.reset_launch_counts()
    out = tk.chained_barrier_matvec(zs, xs[0], ws[0], v0, 16)
    assert tk.launch_counts()["chained_barrier_matvec"] == 1
    ref = tk.chained_barrier_matvec_plain(zs, xs[0], ws[0], v0, 16)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)


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

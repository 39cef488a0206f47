"""NonnegPCA in the port: the problem, its fused tCG entry and operator,
and a tCG call at a cell's own shape that runs every lane ``maxinner``
iterations."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.roofline_count import sphere_tcg_work

# the batched fused tCG (K3) as the solver calls it, a function of
# riptrm_torch.ops.kernels, and the operator it launches
TCG_ENTRY = "fused_tcg_sphere_quadratic_batched"
TCG_OP = "riptrm::sphere_tcg"


def make_problem(arrays, x0, cfg, device, matmul_precision):
    from riptrm_torch.problems import nonneg_pca

    dtype = getattr(torch, cfg["dtype"])
    z = torch.as_tensor(arrays["Z"], dtype=dtype, device=device)
    return nonneg_pca.make_problem(z, x0, dtype=dtype, device=device,
                                   matmul_precision=matmul_precision)


def tcg_call(cfg, lanes, maxinner, device, seed):
    """(call, work): ``call()`` launches K3 once and returns each lane's
    iterations [B]; ``work(iters)`` gives the call's (operations, bytes).
    The inputs follow the port's roofline: barrier weights log-uniform
    over 1e6 and x proportional to their inverse, so CG's model keeps
    decreasing above float32 noise for many iterations, an infinite
    radius, tangent gradients, mininner = maxinner."""
    from riptrm_torch.ops import kernels

    n = cfg["dim"]
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, n))
    z = (z + z.T) * (1e-3 / (2 * np.sqrt(n)))
    ws = 10.0 ** (6.0 * rng.random((lanes, n)))
    xs = 1.0 / ws
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    grads = 0.1 * rng.standard_normal((lanes, n))
    grads -= np.sum(grads * xs, axis=1, keepdims=True) * xs
    zs, xs, ws, grads = (torch.tensor(a, dtype=torch.float32, device=device)
                         for a in (z, xs, ws, grads))
    radii = torch.full((lanes,), 1e18, dtype=torch.float32, device=device)

    def call():
        return kernels.fused_tcg_sphere_quadratic_batched(
            zs, xs, ws, grads, radii, maxinner=maxinner, mininner=maxinner, kappa=1e-30)[2]

    return call, lambda iters: sphere_tcg_work(n, iters)

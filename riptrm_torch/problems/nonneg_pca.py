"""Nonnegative PCA: max x^T Z x on the sphere S^{n-1} with x >= 0.

Counterpart of ``riptrm_tpu/problems/nonneg_pca.py``.  The n per-element
constraints are one stacked function g(x) = -x.  ``matmul_precision``
('high': TF32 on CUDA; 'highest': full float32) is scoped to the problem's
own operators (``problems/problem.py``).  A lane-leading Z [B, n, n] makes
one problem over B instances, each lane's Zs its data (instance batching).
``mesh``/``axis`` split Zs's rows across the ranks of a mesh axis (the JAX
package's row-sharded Z): the cost is the sum of the ranks' partial
quadratic forms (``ops/collectives.py``'s ``enter`` and ``exit_sum``).
Such a problem carries no structure: the fused tCG kernels and the closed
forms of ``problems/structured.py`` need the whole Zs, so every solver takes
its generic path.
"""

from __future__ import annotations

import numpy as np
import torch

from riptrm_torch.config import as_tensor, check_matmul_precision, resolve
from riptrm_torch.manifolds import Sphere
from riptrm_torch.ops.collectives import enter, exit_sum, mesh_axis
from riptrm_torch.problems.problem import Problem
from riptrm_torch.utils.io import loadtxt


def make_problem(Z, x0, y0=None, dtype=None, device=None, matmul_precision=None, mesh=None,
                 axis="tp") -> Problem:
    """Problem from numpy arrays or tensors (``Z`` [n, n], ``x0``/``y0`` [n]).

    Both packages build from the same ``Zs = 0.5 (Z + Z')``: -x'Zx equals
    -x'Zs x exactly, and the symmetric form makes every Hessian application
    one matvec.  A lane-leading ``Z`` [B, n, n] gives the problem of B
    instances: its data and its structure's ``Zs`` are [B, n, n], and
    ``x0``/``y0`` may be [B, n], of which lane 0 is kept (the sweeps take
    their starts as arguments).

    ``mesh``/``axis``: rank i of the axis's t ranks keeps rows [r_i, r_i+1)
    of Zs (``torch.tensor_split``), and its partial cost -x[r_i:r_i+1]' Zs_i x
    contracts them; the partial costs are summed across the axis, and so
    are their gradients, so Zs x is the rows' products of every rank.  The
    problem then has no ``sphere_quadratic`` structure (its Zs would be the
    rank's rows only), so the solvers take the plain tCG and the generic
    Hessian."""
    Z = as_tensor(Z, dtype, device)
    Zs = 0.5 * (Z + Z.mT)
    lanes = Z.ndim == 3
    x0 = as_tensor(x0, Z.dtype, Z.device)
    n = Z.shape[-1]
    if y0 is None:
        y0 = torch.ones(n, dtype=Z.dtype, device=Z.device)
    else:
        y0 = as_tensor(y0, Z.dtype, Z.device)
    if lanes:
        x0, y0 = (a[0] if a.ndim == 2 else a for a in (x0, y0))

    group = None
    if mesh is not None:
        group, size, index = mesh_axis(mesh, axis)
        rows = torch.tensor_split(torch.arange(n), size)[index]
        lo, hi = int(rows[0]), int(rows[-1]) + 1
        Zs = Zs[..., lo:hi, :].contiguous()

    def cost_fn(x, zs=Zs):
        if group is None:
            return -(x @ (zs @ x))
        xe = enter(x, group)
        return exit_sum(-(xe[lo:hi] @ (zs @ xe)), group)

    def ineq_fn(x, *_):
        return -x  # feasible: x >= 0

    def manvio_fn(x, *_):
        return torch.linalg.vector_norm(x) - 1.0

    return Problem(
        manifold=Sphere(n),
        cost_fn=cost_fn,
        ineq_fn=ineq_fn,
        x0=x0,
        y0=y0,
        z0=Z.new_zeros(0),
        num_ineq=n,
        num_eq=0,
        manvio_fn=manvio_fn,
        structure=None if group is not None else {"kind": "sphere_quadratic", "Zs": Zs},
        data=Zs if lanes else None,
        matmul_precision=check_matmul_precision(matmul_precision),
    )


def load_problem(dataset_path: str, initialpoint: str = "a", dtype=None,
                 device=None) -> Problem:
    """Load a shipped instance (``dataset/NonnegPCA/<i>/*.csv``)."""
    Z = loadtxt(f"{dataset_path}/Z.csv")
    x0 = loadtxt(f"{dataset_path}/initx_{initialpoint}.csv")
    y0 = loadtxt(f"{dataset_path}/initineqLagmult.csv")
    return make_problem(Z, x0, y0, dtype=dtype, device=device)


def generate_instance(generator: torch.Generator, dim: int, snr: float = 0.5,
                      delta: float = 0.7, *, dtype=None, device=None):
    """Spiked-covariance instance, the distribution of the JAX generator.

    The draws come from ``generator`` (whose device must be ``device``), so
    the same seed does not give the JAX package's instance.  Returns
    ``{"dim": [[dim]], "Z": tensor [dim, dim]}``."""
    dtype, device = resolve(dtype, device)
    samplesize = int(np.floor(delta * dim))
    kw = dict(generator=generator, dtype=dtype, device=device)
    support = torch.randperm(dim, generator=generator, device=device) < samplesize
    v = support.to(dtype) / np.sqrt(samplesize)
    noise = torch.randn(dim, dim, **kw) / np.sqrt(dim)
    diag_noise = torch.randn(dim, **kw) * 2.0 / np.sqrt(dim)
    eye = torch.eye(dim, dtype=dtype, device=device)
    noise = noise * (1.0 - eye) + torch.diag(diag_noise)
    z = np.sqrt(snr) * torch.outer(v, v) + noise
    return {"dim": np.array([[dim]]), "Z": z}


def generate_initialpoint(generator: torch.Generator, dim: int,
                          feasible: bool = True, *, dtype=None, device=None):
    """Random unit-norm initial point [dim] (uniform entries, normalised)."""
    dtype, device = resolve(dtype, device)
    x0 = torch.rand(dim, generator=generator, dtype=dtype, device=device)
    x0 = x0 / torch.linalg.vector_norm(x0)
    return torch.abs(x0) if feasible else x0

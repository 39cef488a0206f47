"""Bounded-coordinate PCA on the Stiefel manifold (Brockett form):

    max tr(X' Z X D)  on  St(n, p)   s.t.  |X_ij| <= bound  elementwise,

with D = diag(d_1 > ... > d_p > 0).  Counterpart of
``riptrm_tpu/problems/bounded_pca.py``; its docstring says why the bound
is two-sided and why the weights are distinct.  The 2 n p constraints are
one stacked function [x - b, -x - b], flattened row-major.  A lane-leading
Z [B, n, n] makes one problem over B instances, each lane's Zs its data.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from riptrm_torch.config import as_tensor, resolve
from riptrm_torch.manifolds import Stiefel
from riptrm_torch.problems import nonneg_pca
from riptrm_torch.problems.problem import Problem
from riptrm_torch.utils.io import loadtxt


def make_problem(Z, x0, y0=None, bound: float = 0.8, dtype=None, device=None,
                 weights=None) -> Problem:
    """Problem from numpy arrays or tensors (``Z`` [n, n], ``x0`` [n, p],
    ``y0`` [2 n p]); the default Brockett weights are d_k = 1 + (p - k)/p.
    A lane-leading ``Z`` [B, n, n] gives the problem of B instances (data
    and structure ``Zs`` [B, n, n]; of an ``x0`` [B, n, p] lane 0 is
    kept)."""
    Z = as_tensor(Z, dtype, device)
    Zs = 0.5 * (Z + Z.mT)
    lanes = Z.ndim == 3
    dt, dev = Z.dtype, Z.device
    x0 = as_tensor(x0, dt, dev)
    if lanes and x0.ndim == 3:
        x0 = x0[0]
    n, p = x0.shape
    m = 2 * n * p
    y0 = torch.ones(m, dtype=dt, device=dev) if y0 is None else as_tensor(y0, dt, dev)
    if lanes and y0.ndim == 2:
        y0 = y0[0]
    b = torch.tensor(bound, dtype=dt, device=dev)
    if weights is None:
        d = 1.0 + torch.arange(p - 1, -1, -1, dtype=dt, device=dev) / p
    else:
        d = as_tensor(weights, dt, dev)
    eye = torch.eye(p, dtype=dt, device=dev)

    def cost_fn(x, zs=Zs):
        return -torch.sum((x * (zs @ x)) * d)

    def ineq_fn(x, *_):
        # feasible: x <= b and -x <= b, stacked [2 n p]
        return torch.cat([(x - b).reshape(-1), (-x - b).reshape(-1)])

    def manvio_fn(x, *_):
        return torch.linalg.matrix_norm(x.mT @ x - eye)

    return Problem(
        manifold=Stiefel(n, p),
        cost_fn=cost_fn,
        ineq_fn=ineq_fn,
        x0=x0,
        y0=y0,
        z0=Z.new_zeros(0),
        num_ineq=m,
        num_eq=0,
        manvio_fn=manvio_fn,
        # routes the tCG to the Stiefel-bound kernel (ops/kernels.py)
        structure={"kind": "stiefel_bound", "Zs": Zs, "bound": b, "d": d},
        data=Zs if lanes else None,
    )


def load_problem(dataset_path: str, initialpoint: str = "a", bound: float = 0.8,
                 dtype=None, device=None) -> Problem:
    """Load a shipped instance (``dataset/BoundedPCA/<i>/*.csv``, with
    ``dim.csv`` = (n, p))."""
    dims = np.atleast_1d(loadtxt(f"{dataset_path}/dim.csv")).astype(int).ravel()
    n, p = int(dims[0]), int(dims[1])
    Z = loadtxt(f"{dataset_path}/Z.csv").reshape(n, n)
    x0 = loadtxt(f"{dataset_path}/initx_{initialpoint}.csv").reshape(n, p)
    y0 = np.atleast_1d(loadtxt(f"{dataset_path}/initineqLagmult.csv")).reshape(2 * n * p)
    return make_problem(Z, x0, y0, bound=bound, dtype=dtype, device=device)


def generate_instance(generator: torch.Generator, dim: int, snr: float = 0.5,
                      delta: float = 0.7, *, dtype=None, device=None):
    """Spiked-covariance Z, the NonnegPCA construction."""
    return nonneg_pca.generate_instance(generator, dim, snr, delta, dtype=dtype,
                                        device=device)


def generate_initialpoint(generator: torch.Generator, n: int, p: int,
                          bound: float = 0.8, margin: float = 0.05,
                          max_draws: int = 20_000, *, dtype=None, device=None):
    """Strictly feasible orthonormal start [n, p]: QR of a Gaussian matrix,
    redrawn until every |entry| clears the bound by ``margin``."""
    if bound - margin <= 1.0 / math.sqrt(n):
        # every orthonormal column has max|entry| >= 1/sqrt(n): no draw
        # could pass
        raise ValueError(
            f"bound - margin = {bound - margin:.3g} <= 1/sqrt(n) = "
            f"{1.0 / math.sqrt(n):.3g}: no orthonormal frame can satisfy it"
        )
    dtype, device = resolve(dtype, device)
    for _ in range(max_draws):
        a = torch.randn(n, p, generator=generator, dtype=dtype, device=device)
        q, _ = torch.linalg.qr(a)
        if float(torch.max(torch.abs(q))) <= bound - margin:
            return q
    raise ValueError(
        f"no feasible start found in {max_draws} draws (n={n}, p={p}, "
        f"bound={bound}, margin={margin}): the bound is too tight for "
        "random orthonormal frames"
    )

"""Nonnegative low-rank matrix approximation on the fixed-rank manifold.

    min_{X in M_k}  0.5 ||X - A||_F^2   s.t.  X_ij >= lb  elementwise

Counterpart of ``riptrm_tpu/problems/low_rank.py``.  M_k is the manifold of
m x n matrices of rank k in its factored (U, S, V) form, packed per lane
(``manifolds/fixed_rank.py``); the cost and the m*n constraints are
ambient functions of X = (U * S) V', wired through
``problems/embedded.py`` so that every derivative chains through the
embedding.  Solve with the matrix-free paths: RIPTRM's tCG, RIPM's
conjugate residual, RALM.
"""

from __future__ import annotations

import numpy as np
import torch

from riptrm_torch.config import as_tensor, resolve
from riptrm_torch.manifolds.base import randn_on
from riptrm_torch.manifolds.fixed_rank import FixedRankEmbedded
from riptrm_torch.problems.embedded import EmbeddedProblem, ambient_problem
from riptrm_torch.utils.io import loadtxt


def make_problem(A, x0, y0=None, lb: float = 0.0, dtype=None, device=None) -> EmbeddedProblem:
    """``A``: the target [m, n]; ``x0``: the (U [m, k], S [k], V [n, k])
    triple or its packed tensor, packed into ``problem.x0``; feasibility is
    X >= lb elementwise (m*n stacked constraints).  A lane-leading ``A``
    [B, m, n] gives the problem of B instances, each lane's A its data; of
    starts over lanes (``x0`` [B, ...]) lane 0 is kept."""
    A = as_tensor(A, dtype, device)
    lanes = A.ndim == 3
    m, n = A.shape[-2:]
    if isinstance(x0, torch.Tensor):  # packed, one lane or B
        k = _packed_rank(x0.shape[-1], m, n)
        x0 = FixedRankEmbedded(m, n, k).unpack(as_tensor(x0, A.dtype, A.device))
    u0, s0, v0 = (as_tensor(a, A.dtype, A.device) for a in x0)
    if lanes and u0.ndim == 3:
        u0, s0, v0 = u0[0], s0[0], v0[0]
    k = u0.shape[1]
    man = FixedRankEmbedded(m, n, k)
    y0 = (torch.ones(m * n, dtype=A.dtype, device=A.device) if y0 is None
          else as_tensor(y0, A.dtype, A.device))
    if lanes and y0.ndim == 2:
        y0 = y0[0]

    def cost(X, a=A):
        return 0.5 * torch.sum((X - a) ** 2)

    def ineq(X, *_):
        return (lb - X).reshape(-1)  # feasible: X >= lb elementwise

    def manvio_fn(x, *_):
        """Factored-representation consistency: orthonormal U, V and S > 0."""
        u, s, v = man.unpack(x)
        eye = torch.eye(k, dtype=s.dtype, device=s.device)
        return (torch.linalg.matrix_norm(u.mT @ u - eye)
                + torch.linalg.matrix_norm(v.mT @ v - eye)
                + torch.linalg.vector_norm(torch.clamp(s, max=0.0)))

    return ambient_problem(
        man, cost, ineq=ineq,
        x0=man.pack((u0, s0, v0)),
        y0=y0,
        z0=A.new_zeros(0),
        num_ineq=m * n,
        num_eq=0,
        manvio_fn=manvio_fn,
        data=A if lanes else None,
    )


def _packed_rank(width: int, m: int, n: int) -> int:
    """k of a packed fixed-rank point of ``width`` = (m + n + 1) k."""
    k, rem = divmod(width, m + n + 1)
    if rem or k < 1:
        raise ValueError(f"a packed point of width {width} is no rank-k point of "
                         f"{m} x {n} matrices")
    return k


def load_problem(dataset_path: str, initialpoint: str = "a", lb: float = 0.0, dtype=None,
                 device=None) -> EmbeddedProblem:
    """Load an instance of the CSV contract ``dataset/LowRank/<instance>/``:
    dim = [m, n, k], the target A, the factored initial point
    (initU/initS/initV per point name) and the initial multipliers."""
    dims = np.atleast_1d(loadtxt(f"{dataset_path}/dim.csv")).astype(int).ravel()
    m, n, k = int(dims[0]), int(dims[1]), int(dims[2])
    A = loadtxt(f"{dataset_path}/A.csv").reshape(m, n)
    u0 = loadtxt(f"{dataset_path}/initU_{initialpoint}.csv").reshape(m, k)
    s0 = np.atleast_1d(loadtxt(f"{dataset_path}/initS_{initialpoint}.csv")).reshape(k)
    v0 = loadtxt(f"{dataset_path}/initV_{initialpoint}.csv").reshape(n, k)
    y0 = np.atleast_1d(loadtxt(f"{dataset_path}/initineqLagmult.csv")).reshape(m * n)
    return make_problem(A, (u0, s0, v0), y0, lb=lb, dtype=dtype, device=device)


def generate_instance(generator: torch.Generator, m: int, n: int, rank: int,
                      noise: float = 0.01, *, dtype=None, device=None):
    """A nonnegative rank-``rank`` target W H' / sqrt(rank) (entrywise
    |N(0, 1)| factors) plus elementwise noise, the JAX generator's
    distribution (other draws).  ``{"dim": [[m, n, rank]], "A": [m, n]}``."""
    w = torch.abs(randn_on(generator, (m, rank), dtype, device))
    h = torch.abs(randn_on(generator, (n, rank), dtype, device))
    a = w @ h.T / np.sqrt(rank) + noise * randn_on(generator, (m, n), dtype, device)
    return {"dim": np.array([[m, n, rank]]), "A": a}


def generate_initialpoint(generator: torch.Generator, m: int, n: int, k: int,
                          lb: float = 0.0, margin: float = 0.1, *, dtype=None,
                          device=None):
    """A strictly feasible rank-k start: a dominant entrywise-positive
    rank-1 part plus a small rank-(k-1) perturbation, halved until every
    entry clears ``lb`` by ``margin`` (the JAX generator's rule).  Returns
    the (U, S, V) tensors."""
    dtype, device = resolve(dtype, device)
    w = torch.abs(randn_on(generator, (m,), dtype, device)) + 0.5
    h = torch.abs(randn_on(generator, (n,), dtype, device)) + 0.5
    base = torch.outer(w, h)
    pert = torch.zeros((m, n), dtype=dtype, device=device)
    if k > 1:
        pert = (randn_on(generator, (m, k - 1), dtype, device)
                @ randn_on(generator, (n, k - 1), dtype, device).T)
    if float(base.min()) <= lb + margin:
        # halving eps only drives x toward base: lift base itself when it
        # cannot clear the bound
        base = base + (lb + margin - float(base.min())) + 0.1
    eps = 0.1
    x = base + eps * pert
    for _ in range(200):
        if float(x.min()) > lb + margin:
            break
        eps *= 0.5
        x = base + eps * pert
    else:
        raise ValueError(f"no strictly feasible rank-{k} start found (lb={lb}, "
                         f"margin={margin})")
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    return u[:, :k], s[:k], vh[:k, :].T

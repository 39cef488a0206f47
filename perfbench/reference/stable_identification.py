"""StableIdentification: min f(J, R, Q) = ||XP - (I + hA) X||_F^2 / N over
A = (J - R) Q, with J skew-symmetric and R, Q symmetric positive definite,
subject to constraints on entries a = A[r, c] (the upstream's
``coordinator.py``): a box row gives -a + lo <= 0 and a - hi <= 0, an
annulus row -(a - c)^2 + k^2 <= 0.  X and XP are the trajectories' states
and their successors side by side, N columns (19 pairs a trajectory).

The KKT residual, from the published equations in closed form:

* the Euclidean gradient of the Lagrangian f + y'g in A is
  G = -(2h/N) E X' with E = XP - (I + hA) X, plus each constraint's
  multiplier times its derivative in a at its entry (-1, +1 or
  -2(a - c)); in the blocks, dJ = G Q', dR = -G Q', dQ = (J - R)' G;
* the Riemannian gradient on the product: the skew part of dJ
  (Frobenius metric), and P sym(dP) P for P = R, Q (the affine-invariant
  metric tr(P^-1 U P^-1 V));
* its norm in the product metric: Frobenius for J, ||L^-1 U L^-T||_F for
  R and Q with L = chol(P);
* the distance from the manifold (``simulator.py``): ||J + J'|| +
  ||R - R'|| + ||Q - Q'||, inf where R or Q is not positive definite.

Departures from the upstream: none in the equations; the eigenvalues that
decide positive definiteness are those of the blocks' symmetric parts,
as the upstream's, and a lane holding a non-finite entry counts as not
positive definite (the upstream would raise).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.gen import stable_identification as gen
from perfbench.reference import kkt_residual

KIND_LS, KIND_RS, KIND_TWO = gen.KIND_LS, gen.KIND_RS, gen.KIND_TWO


def _sym(a):
    return 0.5 * (a + a.mT)


def _data(arrays, **f64):
    """(X [d, N], XP [d, N]): every trajectory's states but the last, and
    its states but the first, side by side."""
    trajs = torch.as_tensor(np.asarray(arrays["trajectories"]), **f64)
    return (torch.cat(list(trajs[:, :, :-1]), dim=1), torch.cat(list(trajs[:, :, 1:]), dim=1))


def _constraints(constset, **f64):
    """(kinds, rows, cols, p1, p2) of the constraint rows in the upstream's
    order (the generator's expansion of constset), as tensors."""
    kinds, rows, cols, p1, p2 = gen.constraints(constset)
    index = dict(dtype=torch.int64, device=f64["device"])
    return (torch.tensor(kinds, **index), torch.tensor(rows, **index),
            torch.tensor(cols, **index), torch.tensor(p1, **f64), torch.tensor(p2, **f64))


def constraint_values(arrays, x):
    """g [L, m] at points x [L, 3, d, d] (feasible where <= 0), and its
    derivatives in the constrained entries, dg/da [L, m]."""
    f64 = dict(dtype=x.dtype, device=x.device)
    kinds, rows, cols, p1, p2 = _constraints(arrays["constset"], **f64)
    a = ((x[:, 0] - x[:, 1]) @ x[:, 2])[:, rows, cols]
    g = torch.where(kinds == KIND_LS, -a + p1,
                    torch.where(kinds == KIND_RS, a - p2, -(a - p1) ** 2 + p2 ** 2))
    dg = torch.where(kinds == KIND_LS, -torch.ones_like(a),
                     torch.where(kinds == KIND_RS, torch.ones_like(a), -2.0 * (a - p1)))
    return g, dg


def cost(arrays, cfg, x):
    """f [L] at points x [L, 3, d, d]."""
    xd, xpd = _data(arrays, dtype=x.dtype, device=x.device)
    a = (x[:, 0] - x[:, 1]) @ x[:, 2]
    e = xpd - (xd + cfg["h"] * a @ xd)
    return torch.sum(e * e, dim=(1, 2)) / xd.shape[1]


def lagrangian_egrad(arrays, cfg, x, y):
    """The Euclidean gradient of f + y'g in (J, R, Q), [L, 3, d, d]."""
    xd, xpd = _data(arrays, dtype=x.dtype, device=x.device)
    j, r, q = x[:, 0], x[:, 1], x[:, 2]
    a = (j - r) @ q
    e = xpd - (xd + cfg["h"] * a @ xd)
    grad_a = (-2.0 * cfg["h"] / xd.shape[1]) * e @ xd.T
    _, dg = constraint_values(arrays, x)
    _, rows, cols, _, _ = _constraints(arrays["constset"], dtype=x.dtype, device=x.device)
    flat = grad_a.flatten(1).index_add(1, rows * a.shape[-1] + cols, y * dg)
    grad_a = flat.reshape(a.shape)
    return torch.stack([grad_a @ q.mT, -(grad_a @ q.mT), (j - r).mT @ grad_a], dim=1)


def _least_eigenvalue(a):
    """The least eigenvalue [L] of each symmetric a [L, d, d], in slices of
    16384 lanes: cuSOLVER's batched syev refuses 32768 5 x 5 matrices."""
    return torch.cat([torch.linalg.eigvalsh(c)[:, 0] for c in a.split(16384)])


def _chol(p):
    """Cholesky factors [L, d, d] of the blocks, and whether each is
    positive definite (its symmetric part's least eigenvalue > 0 and
    every entry finite)."""
    finite = torch.isfinite(p).flatten(1).all(dim=1)
    eye = torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)
    safe = torch.where(finite[:, None, None], p, eye)
    pd = finite & (_least_eigenvalue(_sym(safe)) > 0)
    l, _ = torch.linalg.cholesky_ex(torch.where(pd[:, None, None], _sym(safe), eye))
    return l, pd


def residual(arrays: dict, cfg: dict, x, y):
    """KKT residuals [L] of answers ``x`` [L, 3, d, d] with multipliers
    ``y`` [L, m], float64 on one device."""
    eg = lagrangian_egrad(arrays, cfg, x, y)
    parts = [0.5 * (eg[:, 0] - eg[:, 0].mT)]  # skew part of dJ
    manvio = torch.linalg.matrix_norm(x[:, 0] + x[:, 0].mT)
    pd_all = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for k in (1, 2):
        p = x[:, k]
        l, pd = _chol(p)
        u = p @ _sym(eg[:, k]) @ p
        w = torch.linalg.solve_triangular(l, u, upper=False)
        parts.append(torch.linalg.solve_triangular(l, w.mT, upper=False))
        manvio = manvio + torch.linalg.matrix_norm(p - p.mT)
        pd_all = pd_all & pd
    rgrad = torch.cat([a.flatten(1) for a in parts], dim=1)
    g, _ = constraint_values(arrays, x)
    manvio = torch.where(pd_all, manvio, torch.full_like(manvio, math.inf))
    return kkt_residual(rgrad, g, y, manvio)

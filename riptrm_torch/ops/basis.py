"""Tangent-space operator materialisation, over lanes.

Counterpart of ``riptrm_tpu/ops/basis.py``: a dim x dim representing
matrix per lane.  Every dense path applies the operator to the basis
directions first, with ONE ``torch.func.vmap`` over the dim basis
directions of the lane-batched operator (one per component on a
``Product``, ``Manifold.map_basis``): that gives the stacked tangents
[B, dim, ...], the size of the basis.  Then one batched contraction with
the basis takes their coordinates (``Manifold.coords_of_stack``).
``to_coords`` is never called under that ``vmap``: its batching rule
broadcasts the lane-batched basis against every mapped direction, a
[dim, B, dim, ...] tensor, dim times the basis.  ``constraint_grad_rows``
fans one frozen ``vjp`` out over the constraints the same way.
``materialize_sharded`` splits the basis directions across the ranks of a
mesh axis and all-gathers the coordinates.
"""

from __future__ import annotations

import torch
from torch.func import vjp, vmap

from riptrm_torch.ops.collectives import all_gather_cat, mesh_axis, shard_range


def materialize(manifold, x, basis, op):
    """Dense matrices A [B, dim, dim] with A[b, i, j] = <basis_i, op(basis_j)>
    at x[b]: ``op`` in metric-orthonormal coordinates.  ``op`` maps
    lane-batched tangents [B, ...] to tangents; it is applied once, mapped
    over the dim basis directions, and the stacked results are contracted
    with the basis once."""
    cols = manifold.map_basis(basis, op, out_dims=1)  # [B, dim, ...]: op(basis_j)
    return manifold.coords_of_stack(x, basis, cols).mT


def materialize_sharded(manifold, x, basis, op, mesh, axis: str = "tp"):
    """``materialize`` with the basis directions split across the ranks of
    ``mesh``'s axis ``axis``: each rank applies ``op`` to its dim / size
    directions only (``Manifold.basis_slice``; on a ``Product`` each
    component's share of them) and takes their coordinates, then an
    all-gather gives every rank the whole [B, dim, dim] matrix for the
    dense TRS or eigendecomposition downstream.  dim must be divisible by
    the axis size."""
    group, size, index = mesh_axis(mesh, axis)
    cols = shard_range(manifold.dim, size, index, f"materialize_sharded: dim over {axis!r}")
    mine = manifold.map_basis(manifold.basis_slice(basis, cols.start, cols.stop), op,
                              out_dims=1)
    return all_gather_cat(manifold.coords_of_stack(x, basis, mine), group, dim=1).mT


def materialize_symmetrized(manifold, x, basis, op):
    """``materialize`` symmetrised, for self-adjoint operators whose
    numerical representation is slightly asymmetric."""
    a = materialize(manifold, x, basis, op)
    return 0.5 * (a + a.mT)


def _householder_w(x):
    """w = x + sign(x_n) e_n and beta = 2 / w'w per lane (``Sphere.basis``)."""
    n = x.shape[-1]
    s = torch.where(x[:, n - 1] >= 0, 1.0, -1.0).to(x.dtype)
    w = x.clone()
    w[:, n - 1] += s
    return w, 2.0 / torch.sum(w * w, dim=-1)


def sphere_householder_congruence(x, a_mat, kappa):
    """Closed-form O(n^2) coordinate materialisation on the sphere.

    For ``op(v) = P a_mat v - kappa v`` on the tangent space at x in S^{n-1}
    (every Riemannian Hessian on the sphere has this form), the matrix in
    ``Sphere.basis``'s Householder basis is the congruence
    (H a_mat H)[:n-1, :n-1] - kappa I with H = I - beta w w': two symmetric
    rank-1 updates around one matvec a_mat w, in place of dim operator
    applications.  ``x`` [B, n], ``a_mat`` [B, n, n], ``kappa`` [B];
    returns [B, n-1, n-1]."""
    n = x.shape[-1]
    w, beta = _householder_w(x)
    u = torch.einsum("bij,bj->bi", a_mat, w)
    v = -beta[:, None] * u + (0.5 * beta * beta * torch.sum(w * u, dim=-1))[:, None] * w
    m = a_mat + w[:, :, None] * v[:, None, :] + v[:, :, None] * w[:, None, :]
    eye = torch.eye(n - 1, dtype=a_mat.dtype, device=a_mat.device)
    h = m[:, : n - 1, : n - 1] - kappa[:, None, None] * eye
    return 0.5 * (h + h.mT)


def sphere_householder_coords(x, v_amb):
    """Coordinates [B, n-1] of the tangent projection of ambient ``v_amb``
    [B, n] in the Householder basis, without the basis: (H v)[:n-1]."""
    n = x.shape[-1]
    w, beta = _householder_w(x)
    return (v_amb - (beta * torch.sum(w * v_amb, dim=-1))[:, None] * w)[:, : n - 1]


def covector(manifold, x, basis, v):
    """Coordinates of a tangent vector v."""
    return manifold.to_coords(x, basis, v)


def constraint_grad_rows(manifold, x, basis, fn, m, dtype=None):
    """Rows of Riemannian constraint gradients in basis coordinates, per lane.

    G[b, i, :] = coords of rgrad fn_i at x[b] for a stacked per-lane
    constraint function ``fn: point -> [m]``: ONE ``vjp`` of the
    lane-batched constraints, pulled back along the m coordinate covectors
    with a single ``torch.func.vmap`` into the stacked gradients [B, m,
    ...], whose coordinates one contraction with the basis takes.  Returns
    [B, m, dim]."""
    lanes = x.shape[0]
    _, pullback = vjp(lambda xx: vmap(fn)(xx), x)

    def rgrad(e):  # the i-th covector of every lane, [B, m]
        (eg,) = pullback(e)
        return manifold.egrad2rgrad(x, eg)

    eye = torch.eye(m, dtype=x.dtype if dtype is None else dtype, device=x.device)
    grads = vmap(rgrad, out_dims=1)(eye[:, None, :].expand(m, lanes, m))
    return manifold.coords_of_stack(x, basis, grads)

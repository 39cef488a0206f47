"""Spectra of tangent-space operators, over lanes.

Counterpart of ``riptrm_tpu/ops/spectrum.py``:

* ``operator_spectrum``: the self-adjoint operator materialised in the
  tangent basis, then one batched symmetric ``eigh``;
* ``lanczos``: matrix-free Lanczos with full reorthogonalisation for the
  extreme eigenvalues, every lane in lockstep (one ``eigvalsh`` on the
  [B, k, k] tridiagonals at the end).
"""

from __future__ import annotations

import math

import torch
from torch.func import grad

from riptrm_torch.ops.basis import materialize_symmetrized


def _finite_lanes(a):
    """(a with every non-finite lane's matrix replaced by I, that mask)."""
    bad = ~torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.where(bad[..., None, None], eye, a), bad


# the most matrices one batched symmetric eigendecomposition takes: on
# CUDA, cuSOLVER's batched syev refuses a batch of 32768 5 x 5 matrices
# (CUSOLVER_STATUS_INVALID_VALUE), so larger batches run in slices
EIGH_BATCH = 16384


def _batched(fn, a):
    """``fn`` of the stacked matrices ``a`` [..., n, n], in slices of at
    most ``EIGH_BATCH`` matrices.  (Under ``vmap`` the mapped axis is not
    sliced.)"""
    lead = a.shape[:-2]
    count = math.prod(lead)
    if count <= EIGH_BATCH:
        return fn(a)
    parts = [fn(c) for c in a.reshape(count, *a.shape[-2:]).split(EIGH_BATCH)]

    def join(ts):
        return torch.cat(ts).reshape(lead + ts[0].shape[1:])

    return tuple(map(join, zip(*parts))) if isinstance(parts[0], tuple) else join(parts)


def eigh_nan(a):
    """Batched ``torch.linalg.eigh``, NaN on the lanes whose matrix is not
    finite: torch raises there, where the JAX function returns NaN."""
    safe, bad = _finite_lanes(a)
    lam, q = _batched(torch.linalg.eigh, safe)
    return (torch.where(bad[..., None], math.nan, lam),
            torch.where(bad[..., None, None], math.nan, q))


def eigvalsh_nan(a):
    """Batched ``torch.linalg.eigvalsh``, NaN on non-finite lanes."""
    safe, bad = _finite_lanes(a)
    return torch.where(bad[..., None], math.nan, _batched(torch.linalg.eigvalsh, safe))


def operator_spectrum(manifold, x, op, *, descending_abs=True):
    """Eigendecomposition of a self-adjoint tangent-space operator per lane.

    Returns (w [B, dim], vecs [B, dim, ...]): ``vecs[:, i]`` is the tangent
    eigenvector of ``w[:, i]``.  Ordered by |eigenvalue| descending, as the
    reference, unless ``descending_abs=False`` (ascending)."""
    basis = manifold.basis(x)
    a = materialize_symmetrized(manifold, x, basis, op)
    w, v = eigh_nan(a)  # ascending
    if descending_abs:
        order = torch.argsort(-torch.abs(w), dim=-1, stable=True)
        w = torch.gather(w, -1, order)
        v = torch.gather(v, -1, order[:, None, :].expand_as(v))
    # the eigenvectors as tangents: column i of v in the basis, [B, dim, ...]
    vecs = manifold.from_coords(x, basis, v.mT)
    return w, vecs


def hessian_spectrum(problem, x, *, descending_abs=True):
    """Spectrum of the Riemannian Hessian of the cost."""
    return operator_spectrum(
        problem.manifold, x, lambda v: problem.rhess(x, v), descending_abs=descending_abs
    )


def lanczos(matvec, v0, inner, num_iters: int):
    """Matrix-free Lanczos tridiagonalisation with full reorthogonalisation,
    independently on each lane.

    ``matvec``: lane-batched tangents [B, ...] -> tangents (self-adjoint
    under ``inner``); ``v0``: start vectors [B, ...]; ``inner(u, w)``: the
    metric inner product per lane, [B].  Returns (alphas [B, k], betas
    [B, k-1], ritz values [B, k], ascending).

    The recurrence runs in the metric geometry: M w = grad_u <u, w> (exact,
    since ``inner`` is bilinear), and every dot and orthogonalisation uses
    q_i' M q_j; on the flat metrics of the sphere and Stiefel M is the
    identity.  Krylov breakdown (v0 spanning an invariant subspace of
    dimension d < k) is masked as in the JAX function: the steps after it
    contribute alphas[0] diagonal entries with zero coupling, so the extreme
    Ritz values are those of the live block (zero rows would inject
    spurious zero eigenvalues).
    """
    shape = v0.shape
    b = shape[0]
    flat0 = v0.reshape(b, -1)
    dt = flat0.dtype
    eps = torch.finfo(dt).eps
    tiny = torch.finfo(dt).tiny

    def m_flat(w_flat):
        w = w_flat.reshape(shape)
        mw = grad(lambda u: inner(u, w).sum())(w)
        return mw.reshape(b, -1)

    def dot(u, w):
        return torch.sum(u * w, dim=-1)

    m0 = m_flat(flat0)
    nrm0 = torch.sqrt(torch.clamp(dot(flat0, m0), min=tiny))[:, None]
    q, mq = flat0 / nrm0, m0 / nrm0
    q_prev, mq_prev = torch.zeros_like(q), torch.zeros_like(q)
    beta_prev = torch.zeros(b, dtype=dt, device=flat0.device)
    alive = torch.ones(b, dtype=torch.bool, device=flat0.device)
    big_q = torch.zeros((b, num_iters, q.shape[1]), dtype=dt, device=q.device)
    big_mq = torch.zeros_like(big_q)
    alphas, betas, alives = [], [], []
    for i in range(num_iters):
        w = matvec(q.reshape(shape)).reshape(b, -1)
        mw = m_flat(w)
        alpha = dot(mq, w)
        r = w - alpha[:, None] * q - beta_prev[:, None] * q_prev
        mr = mw - alpha[:, None] * mq - beta_prev[:, None] * mq_prev
        # full reorthogonalisation against the stored basis (rows < i)
        coeff = torch.einsum("bkn,bn->bk", big_mq, r)
        r = r - torch.einsum("bkn,bk->bn", big_q, coeff)
        mr = mr - torch.einsum("bkn,bk->bn", big_mq, coeff)
        beta = torch.sqrt(torch.clamp(dot(r, mr), min=0.0))
        wnorm = torch.sqrt(torch.clamp(dot(w, mw), min=0.0))
        alive_next = alive & (beta > 100.0 * eps * torch.clamp(wnorm, min=1.0))
        safe_beta = torch.where(beta > 0, beta, torch.ones_like(beta))[:, None]
        big_q[:, i] = q
        big_mq[:, i] = mq
        alphas.append(alpha)
        betas.append(beta)
        alives.append(alive)
        q_prev, mq_prev, q, mq = q, mq, r / safe_beta, mr / safe_beta
        beta_prev, alive = beta, alive_next
    alphas, betas, alive = (torch.stack(t, dim=1) for t in (alphas, betas, alives))
    alphas_v = torch.where(alive, alphas, alphas[:, :1])
    betas_v = torch.where(alive[:, 1:], betas[:, :-1], torch.zeros_like(betas[:, :-1]))
    t = (torch.diag_embed(alphas_v) + torch.diag_embed(betas_v, 1)
         + torch.diag_embed(betas_v, -1))
    return alphas_v, betas_v, eigvalsh_nan(t)

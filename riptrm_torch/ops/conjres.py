"""Matrix-free conjugate residual method on a (product) tangent space, over
lanes.

Counterpart of ``riptrm_tpu/ops/conjres.py`` (Saad, Iterative Methods for
Sparse Linear Systems, Alg. 6.20).  The JAX ``while_loop`` is a lane-masked
``utils/lanes.py::lane_loop`` here (eagerly one host check of "any lane
running" an iteration, under tracing a ``while_loop`` operator): a lane
that has converged or used its ``maxiter`` keeps its values bit for bit
while the others go on.  A vector is a tuple of lane-batched tensors
(e.g. ``(dx [B, n], dy [B, l])``); ``inner`` returns [B].
"""

from __future__ import annotations

import torch

from riptrm_torch.utils.lanes import bcast, lane_loop, where_lanes


def _axpy(alpha, x, y):
    """y + alpha x per lane, over the parts of a tuple vector."""
    return tuple(yi + bcast(alpha, yi) * xi for xi, yi in zip(x, y))


def _safe(d):
    return torch.where(d == 0, torch.ones_like(d), d)


def conjugate_residual(inner, A, b, v0, *, tol, maxiter, stop_norm=None):
    """Solve A(v) = b on every lane for self-adjoint A w.r.t. ``inner(u, w)``.

    ``b`` and ``v0`` are tuples of [B, ...] tensors; ``A`` maps such a tuple
    to another.  ``stop_norm(r) -> [B]``: optional norm for the stopping
    test (relative to ``stop_norm(b)``), defaulting to the ``inner``-norm;
    a symmetrically preconditioned caller passes the original system's
    residual norm.  Returns (v, iterations [B], rel_res [B])."""
    if stop_norm is None:
        stop_norm = lambda r: torch.sqrt(inner(r, r))

    r = tuple(bi - ai for bi, ai in zip(b, A(v0)))
    b_norm = stop_norm(b)
    b_norm = torch.clamp(b_norm, min=torch.finfo(b_norm.dtype).tiny)
    ar = A(r)
    v, p, ap = v0, r, ar
    r_ar = inner(r, ar)
    rel_res = stop_norm(r) / b_norm
    t = torch.zeros(b_norm.shape, dtype=torch.int64, device=b_norm.device)
    done = torch.zeros(b_norm.shape, dtype=torch.bool, device=b_norm.device)
    def running(v, r, p, ap, r_ar, rel_res, done, t):
        return ((~done) & (t < maxiter)).any()

    def body(_, v, r, p, ap, r_ar, rel_res, done, t):
        active = (~done) & (t < maxiter)
        ap_ap = inner(ap, ap)
        a = r_ar / _safe(ap_ap)
        v_n = _axpy(a, p, v)
        r_n = _axpy(-a, ap, r)
        rel_n = stop_norm(r_n) / b_norm
        done_n = rel_n < tol
        ar_n = A(r_n)
        r_ar_n = inner(r_n, ar_n)
        beta = r_ar_n / _safe(r_ar)
        p_n = _axpy(beta, p, r_n)
        ap_n = _axpy(beta, ap, ar_n)
        # a finished lane keeps its values exactly
        keep = lambda new, old: tuple(where_lanes(active, n, o) for n, o in zip(new, old))
        v, r, p, ap = keep(v_n, v), keep(r_n, r), keep(p_n, p), keep(ap_n, ap)
        r_ar = torch.where(active, r_ar_n, r_ar)
        rel_res = torch.where(active, rel_n, rel_res)
        done = torch.where(active, done_n, done)
        return v, r, p, ap, r_ar, rel_res, done, t + active.to(t.dtype)

    v, _, _, _, _, rel_res, _, t = lane_loop(running, body,
                                             (v, r, p, ap, r_ar, rel_res, done, t), maxiter)
    return v, t, rel_res

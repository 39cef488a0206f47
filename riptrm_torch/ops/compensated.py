"""Compensated (double-word) reductions for float32 lane sweeps.

Counterpart of ``riptrm_tpu/ops/compensated.py``: error-free transforms
(Knuth's TwoSum, Dekker's TwoProd with his split) and the reductions built
on them, the complementarity norm ||y*c - mu|| and the barrier log-ratio
sum of RIPTRM's ared, each as if computed at twice the working precision,
over the last axis (so over each lane of a [B, m] tensor).

These run in eager PyTorch, one elementwise kernel per operation, and must
stay out of ``torch.compile``: a fused kernel may contract ``a*b + c``
into an FMA, which changes the rounding the error-free transforms recover
and breaks their exactness.  No FMA is assumed anywhere.
"""

from __future__ import annotations

import torch


def two_sum(a, b):
    """Knuth TwoSum: (s, e) with s = fl(a+b) and s + e = a + b exactly."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _splitter(dtype):
    # 2^ceil(t/2) + 1 with t the significand width: 27 bits for float64
    # (t = 53), 12 for float32 (t = 24)
    return 134217729.0 if torch.finfo(dtype).bits == 64 else 4097.0


def _split(a):
    """Dekker split: a = hi + lo with both halves half-width exact."""
    c = _splitter(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: (p, e) with p = fl(a*b) and p + e = a*b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def sum2(x, dim=-1):
    """Compensated sum along ``dim``: a TwoSum reduction tree whose per-level
    errors are accumulated, giving the result as if computed at twice the
    working precision (error O(eps|sum| + eps^2 sum|x|)); log2(m) levels."""
    x = torch.movedim(x, dim, -1)
    err = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
        s, e = two_sum(x[..., ::2], x[..., 1::2])
        # level errors are O(eps * partials): their plain sum contributes at
        # O(eps^2) only
        err = err + torch.sum(e, dim=-1)
        x = s
    if x.shape[-1] == 0:
        return err
    return x[..., 0] + err


def dot2(a, b, dim=-1):
    """Compensated dot product (Ogita-Rump-Oishi Dot2)."""
    p, e = two_prod(a, b)
    return sum2(p, dim=dim) + torch.sum(e, dim=dim)


def complementarity_norm(y, c, mu):
    """Compensated ||y*c - mu||_2 over the last axis; ``mu`` a number or a
    per-lane [B] (broadcast over the last axis).

    TwoProd recovers each product's rounding and TwoSum cancels against mu
    error-free, so the per-element residual is accurate to eps*|residual|
    instead of eps*mu; the squared sum runs through the compensated tree."""
    mu = torch.as_tensor(mu, dtype=y.dtype, device=y.device)
    if mu.ndim:
        mu = mu[..., None]
    p, e = two_prod(y, c)
    d, de = two_sum(p, -mu)
    r = d + (e + de)
    return torch.sqrt(torch.clamp(dot2(r, r), min=0.0))


def barrier_log_ratio_sum(c_new, c, mu):
    """Compensated mu * sum_i log(c_new_i / c_i) over the last axis (the ared
    barrier term); ``mu`` a number or a per-lane [B].

    ``log1p((c_new - c)/c)`` is conditioned on the difference (exact where
    the ratio lies in [1/2, 2]) and the m terms accumulate through the
    compensated tree.  Non-positive slack pairs contribute 0, as the
    plain path's ratio-1 masking."""
    ok = (c_new > 0) & (c > 0)
    one = torch.ones_like(c)
    safe_c = torch.where(ok, c, one)
    safe_cn = torch.where(ok, c_new, one)
    t = (safe_cn - safe_c) / safe_c
    near = t > -0.5  # ratio > 1/2: the log1p form is the conditioned one
    terms = torch.where(
        near,
        torch.log1p(torch.where(near, t, torch.zeros_like(t))),
        torch.log(torch.where(near, one, safe_cn / safe_c)),
    )
    return torch.as_tensor(mu, dtype=c.dtype, device=c.device) * sum2(terms)

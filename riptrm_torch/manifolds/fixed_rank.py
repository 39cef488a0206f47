"""Fixed-rank embedded manifold of m x n matrices of rank k, over a leading
lane axis, its factored points and tangents packed in one tensor per lane.

Counterpart of ``riptrm_tpu/manifolds/fixed_rank.py`` (Vandereycken 2013).
A point is (U [m, k], S [k], V [n, k]) with U, V orthonormal, the matrix
(U * S) V'; a tangent is (M [k, k], Up [m, k], Vp [n, k]) with U'Up = 0,
V'Vp = 0, the matrix U M V' + Up V' + U Vp'.  The metric is the Frobenius
metric of the embedding.  The JAX package keeps the triples as tuples;
here each is flattened and concatenated: a point is [B, (m + n + 1) k], a
tangent [B, (k + m + n) k], the two of different lengths
(``unpack``/``unpack_tangent`` give the factor views, also of one lane).

Problems on this manifold are built with ``problems/embedded.py``
(derivatives taken in the ambient m x n space) and run through the
matrix-free solver paths: RIPTRM's tCG, RIPM's conjugate residual, RALM.
There is no closed-form tangent basis, as in the JAX package: ``basis``
raises, and with it exact mode, RSQO and RIPM's dense solve.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from riptrm_torch.manifolds.base import Manifold, randn_on


@dataclasses.dataclass(frozen=True)
class FixedRankEmbedded(Manifold):
    m: int
    n: int
    k: int

    @property
    def dim(self) -> int:
        return (self.m + self.n - self.k) * self.k

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.dim)

    # ---- packed layout -------------------------------------------------
    @property
    def point_shape(self) -> tuple:
        return ((self.m + self.n + 1) * self.k,)

    @property
    def tangent_shape(self) -> tuple:
        return ((self.k + self.m + self.n) * self.k,)

    def pack(self, parts):
        u, s, v = parts
        lead = s.shape[:-1]
        return torch.cat([u.reshape(lead + (-1,)), s, v.reshape(lead + (-1,))], dim=-1)

    def unpack(self, x):
        m, n, k = self.m, self.n, self.k
        lead = x.shape[:-1]
        return (x[..., : m * k].reshape(lead + (m, k)), x[..., m * k: m * k + k],
                x[..., m * k + k:].reshape(lead + (n, k)))

    def pack_tangent(self, parts):
        mm, up, vp = parts
        lead = mm.shape[:-2]
        return torch.cat([a.reshape(lead + (-1,)) for a in (mm, up, vp)], dim=-1)

    def unpack_tangent(self, t):
        m, n, k = self.m, self.n, self.k
        lead = t.shape[:-1]
        return (t[..., : k * k].reshape(lead + (k, k)),
                t[..., k * k: k * k + m * k].reshape(lead + (m, k)),
                t[..., k * k + m * k:].reshape(lead + (n, k)))

    def embed_point(self, x):
        u, s, v = self.unpack(x)
        return (u * s[..., None, :]) @ v.mT

    def embed_tangent(self, x, t):
        u, _, v = self.unpack(x)
        mm, up, vp = self.unpack_tangent(t)
        return u @ mm @ v.mT + up @ v.mT + u @ vp.mT

    # ---- geometry ------------------------------------------------------
    def inner(self, x, t1, t2):
        return torch.sum(t1 * t2, dim=-1)

    def proj(self, x, z):
        """Project an ambient m x n matrix [..., m, n] onto T_x M."""
        u, _, v = self.unpack(x)
        zv = z @ v
        uz = z.mT @ u
        mm = u.mT @ zv
        return self.pack_tangent((mm, zv - u @ mm, uz - v @ mm.mT))

    def proj_tangent(self, x, t):
        """Re-impose U'Up = 0 and V'Vp = 0 on a drifted tangent."""
        u, _, v = self.unpack(x)
        mm, up, vp = self.unpack_tangent(t)
        return self.pack_tangent((mm, up - u @ (u.mT @ up), vp - v @ (v.mT @ vp)))

    def retract(self, x, t):
        """Metric projection retraction: the rank-k truncated SVD of X + t,
        from the compact form [U Qu] [[S+M, Rv'], [Ru, 0]] [V Qv]' with
        Up = Qu Ru and Vp = Qv Rv, one 2k x 2k SVD, then one symmetric
        re-orthonormalisation step Q(3I - Q'Q)/2 of the new factors (the
        JAX package's, against the drift of long solves)."""
        u, s, v = self.unpack(x)
        mm, up, vp = self.unpack_tangent(t)
        k = self.k
        qu, ru = torch.linalg.qr(up)
        qv, rv = torch.linalg.qr(vp)
        top = torch.cat([torch.diag_embed(s) + mm, rv.mT], dim=-1)
        bottom = torch.cat([ru, torch.zeros_like(ru)], dim=-1)
        core = torch.cat([top, bottom], dim=-2)
        # gesvd on CUDA, as Stiefel.retract
        driver = "gesvd" if x.is_cuda else None
        uu, ss, vvh = torch.linalg.svd(core, driver=driver)
        u_new = torch.cat([u, qu], dim=-1) @ uu[..., :, :k]
        v_new = torch.cat([v, qv], dim=-1) @ vvh[..., :k, :].mT
        eye_k = 1.5 * torch.eye(k, dtype=s.dtype, device=s.device)
        u_new = u_new @ (eye_k - 0.5 * (u_new.mT @ u_new))
        v_new = v_new @ (eye_k - 0.5 * (v_new.mT @ v_new))
        return self.pack((u_new, ss[..., :k], v_new))

    def dist(self, x, y):
        return torch.linalg.matrix_norm(self.embed_point(x) - self.embed_point(y))

    def zero_vector(self, x):
        return x.new_zeros(x.shape[:-1] + self.tangent_shape)

    def egrad2rgrad(self, x, egrad):
        """``egrad`` is the ambient m x n Euclidean gradient."""
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, t):
        """Vandereycken's curvature correction; ``egrad`` and ``ehess`` are
        ambient m x n matrices."""
        u, s, v = self.unpack(x)
        _, up, vp = self.unpack_tangent(t)
        r_m, r_up, r_vp = self.unpack_tangent(self.proj(x, ehess))
        s_inv = (1.0 / s)[..., None, :]
        t1 = egrad @ vp  # [m, k]
        t2 = egrad.mT @ up  # [n, k]
        up_c = (t1 - u @ (u.mT @ t1)) * s_inv
        vp_c = (t2 - v @ (v.mT @ t2)) * s_inv
        return self.pack_tangent((r_m, r_up + up_c, r_vp + vp_c))

    def transport(self, x, y, t):
        return self.proj(y, self.embed_tangent(x, t))

    def random_point(self, generator, lanes=1, *, dtype=None, device=None):
        qu, _ = torch.linalg.qr(randn_on(generator, (lanes, self.m, self.k), dtype, device))
        qv, _ = torch.linalg.qr(randn_on(generator, (lanes, self.n, self.k), dtype, device))
        s = torch.abs(randn_on(generator, (lanes, self.k), dtype, device))
        s = torch.sort(s, dim=-1, descending=True).values + 0.5
        return self.pack((qu, s, qv))

    def random_tangent(self, x, generator):
        z = torch.randn(x.shape[:-1] + (self.m, self.n), generator=generator, dtype=x.dtype,
                        device=x.device)
        t = self.proj(x, z)
        return t / self.norm(x, t)[..., None]

    def basis(self, x):
        raise NotImplementedError(
            "FixedRankEmbedded has no closed-form dense basis here; use the "
            "matrix-free solver paths (tCG / conjugate residual / Lanczos)."
        )

"""Manifold protocol over a leading lane axis.

Counterpart of ``riptrm_tpu/manifolds/base.py``.  Points and tangent
vectors are tensors ``[B, ...]`` whose first axis is the lane (one
independent solve per lane); every scalar-valued operation returns ``[B]``.
The JAX package gets its lanes from ``vmap``; here they are written out,
so one step function serves the host runner (B = 1) and the batched sweep.

The closed-form tangent bases (``basis``/``to_coords``/``from_coords``),
``orthonormal_completion`` and ``_skew_basis`` belong to exact mode and are
not ported yet (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

import dataclasses

import torch

from riptrm_torch.config import resolve


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Abstract base; subclasses are frozen dataclasses of static shapes."""

    @property
    def dim(self) -> int:  # intrinsic dimension
        raise NotImplementedError

    @property
    def typical_dist(self) -> float:
        raise NotImplementedError

    def inner(self, x, u, v) -> torch.Tensor:
        """Metric inner product per lane: [B]."""
        raise NotImplementedError

    def norm(self, x, u) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.inner(x, u, u), min=0.0))

    def proj(self, x, v):
        """Orthogonal projection of an ambient vector onto T_x M."""
        raise NotImplementedError

    def retract(self, x, v):
        raise NotImplementedError

    def dist(self, x, y) -> torch.Tensor:
        raise NotImplementedError

    def zero_vector(self, x):
        return torch.zeros_like(x)

    def egrad2rgrad(self, x, egrad):
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        raise NotImplementedError

    def proj_tangent(self, x, t):
        """Re-project a drifted tangent-typed value back onto T_x M."""
        return self.proj(x, t)

    def transport(self, x, y, v):
        """Projection transport of v from T_x to T_y."""
        return self.proj(y, v)

    def random_point(self, generator: torch.Generator, lanes: int = 1, *,
                     dtype=None, device=None):
        raise NotImplementedError

    def random_tangent(self, x, generator: torch.Generator):
        raise NotImplementedError


def randn_on(generator, shape, dtype=None, device=None):
    """Standard normal draws of ``shape`` from ``generator``, on ``device``
    (default: the card, ``config.resolve``).  The draw is made on the
    generator's own device and then moved, since a CPU generator cannot
    feed a CUDA draw."""
    dtype, device = resolve(dtype, device)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def sym(a):
    """Symmetric part over the last two axes, e.g. of lane-batched [B, p, p]."""
    return 0.5 * (a + a.mT)


def skew(a):
    """Skew-symmetric part over the last two axes."""
    return 0.5 * (a - a.mT)

"""Dtype and device helpers.

There is no global configuration: every entry point takes ``device`` and
``dtype``.  The defaults are the reference protocol's float64 (tolerances
down to 1e-15) on the CPU; a caller that wants the card passes
``device="cuda"`` (``utils/devices.py::cuda_device``).
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DTYPE = torch.float64
DEFAULT_DEVICE = torch.device("cpu")


def resolve(dtype=None, device=None):
    """(dtype, device) with the package defaults filled in."""
    return (
        DEFAULT_DTYPE if dtype is None else dtype,
        DEFAULT_DEVICE if device is None else torch.device(device),
    )


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """numpy array, tensor or nested list -> tensor of the given dtype and
    device (float64 on the CPU by default; a tensor keeps its own dtype and
    device unless they are given)."""
    if isinstance(a, torch.Tensor):
        return a.to(
            dtype=a.dtype if dtype is None else dtype,
            device=a.device if device is None else torch.device(device),
        )
    dtype, device = resolve(dtype, device)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)  # a copy

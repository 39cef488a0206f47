"""Dtype and device helpers.

There is no global configuration: every entry point takes ``device`` and
``dtype``.  The defaults are the reference protocol's float64 (tolerances
down to 1e-15) on the card: ``device=None`` means CUDA device 0
(``utils/devices.py::cuda_device``), and raises where CUDA is absent; it
never falls back to the CPU.  A caller that wants the CPU, as the tests
do, passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from riptrm_torch.utils.devices import cuda_device

DEFAULT_DTYPE = torch.float64


def resolve(dtype=None, device=None):
    """(dtype, device) with the package defaults filled in: float64, and
    CUDA device 0 (raises without CUDA)."""
    return (
        DEFAULT_DTYPE if dtype is None else dtype,
        cuda_device() if device is None else torch.device(device),
    )


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """numpy array, tensor or nested list -> tensor of the given dtype and
    device (float64 on the card by default; a tensor keeps its own dtype and
    device unless they are given)."""
    if isinstance(a, torch.Tensor):
        return a.to(
            dtype=a.dtype if dtype is None else dtype,
            device=a.device if device is None else torch.device(device),
        )
    dtype, device = resolve(dtype, device)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)  # a copy


# A problem's ``matmul_precision`` names, as in the JAX package: 'high' is
# TF32 on CUDA (torch's own name), 'highest' full float32.
MATMUL_PRECISIONS = ("high", "highest")


def check_matmul_precision(precision):
    """``precision`` if it is None or one of ``MATMUL_PRECISIONS``; raises
    otherwise."""
    if precision is not None and precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision={precision!r}: None, 'high' (TF32 on CUDA) or "
                         "'highest' (full float32)")
    return precision


@contextlib.contextmanager
def matmul_precision(precision: str):
    """``torch``'s float32 matmul precision set to ``precision`` inside the
    block and restored on exit, however the block ends."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(check_matmul_precision(precision))
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)

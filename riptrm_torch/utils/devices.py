"""Device selection helpers."""

from __future__ import annotations

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when CUDA is absent.

    The library never picks a device on its own: scripts that must run on
    the card (``chip_smoke.py``) call this and fail loudly instead of
    falling back to the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this entry point needs a GPU")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present"
        )
    return torch.device("cuda", index)

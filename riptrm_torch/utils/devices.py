"""Device selection helpers."""

from __future__ import annotations

import subprocess

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when CUDA is absent.

    The package's default device (``config.resolve`` with ``device=None``)
    and the scripts that must run on the card (``chip_smoke.py``, the
    roofline) come through here, and fail loudly instead of falling back
    to the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this entry point needs a GPU")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present"
        )
    return torch.device("cuda", index)


def name_and_power_limit() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]

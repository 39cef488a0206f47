"""Seeded inputs of a NonnegPCA deployment, in NumPy on the host.

A copy of the recipes of ``riptrm_torch/problems/nonneg_pca.py``
(``generate_instance``, ``generate_initialpoint``): a spiked covariance
Z = sqrt(snr) v v' + noise, with v uniform on a random support of
floor(delta n) coordinates, the noise N(0, 1/n) off the diagonal and
N(0, 4/n) on it; starts with uniform positive entries, scaled to unit
norm.  The draws come from a NumPy generator, so the same seed gives the
same arrays here and nowhere else.
"""

from __future__ import annotations

import numpy as np


def instance(rng: np.random.Generator, cfg: dict) -> dict:
    """{"Z": [n, n] float64}."""
    n, snr, delta = cfg["dim"], cfg["snr"], cfg["delta"]
    samplesize = int(np.floor(delta * n))
    v = (rng.permutation(n) < samplesize) / np.sqrt(samplesize)
    noise = rng.standard_normal((n, n)) / np.sqrt(n)
    np.fill_diagonal(noise, rng.standard_normal(n) * 2.0 / np.sqrt(n))
    return {"Z": np.sqrt(snr) * np.outer(v, v) + noise}


def starts(rng: np.random.Generator, cfg: dict, count: int) -> np.ndarray:
    """``count`` strictly feasible unit starts [count, n] float64."""
    x = rng.random((count, cfg["dim"]))
    return x / np.linalg.norm(x, axis=1, keepdims=True)

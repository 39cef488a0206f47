"""CSV IO helpers preserving the dataset contract of ``riptrm_tpu.utils.io``
(``dataset/<problem>/<instance>/*.csv`` written with ``np.savetxt``)."""

from __future__ import annotations

import os

import numpy as np


def loadtxt(path):
    return np.loadtxt(path)


def savetxt(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, np.asarray(arr))

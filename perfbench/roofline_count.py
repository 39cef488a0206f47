"""Operations and bytes of the port's tCG kernels, and the card's peaks.

Copied from ``riptrm_torch/experiment/roofline.py``'s accounting.  A
kernel's share of its roofline is the least time the card could take for
the call, the larger of its FP32 operations over ``PEAK_FP32`` and its
bytes over ``PEAK_HBM``, over the measured time.  Bytes count each input
read once and each output written once, except Zs when it exceeds the L2:
then it counts once per pass.  Operations count each lane's own tCG
iterations.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, 700 W: FP32 on the CUDA cores (no tensor
# cores), HBM3, L2
PEAK_FP32 = 67e12  # FLOP/s
PEAK_HBM = 3.35e12  # B/s
L2_BYTES = 50 * 2**20
F32 = 4  # bytes

# Operations per vector entry beyond the matvec, counted from the kernel's
# loop: a sphere tCG iteration (Hw(v), its projections, the CG dots and
# updates) 40.
SPHERE_TCG_VEC_OPS = 40


def roofline_bound(ops: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the least time for ``ops`` FP32
    operations and ``nbytes`` bytes, and which of the two sets it."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_HBM
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def zs_bytes(n: int, passes) -> float:
    """Bytes of an [n, n] float32 Zs read by ``passes`` passes: once while
    it fits the L2, else once a pass."""
    once = F32 * n * n
    return float(once if once <= L2_BYTES else max(1, passes) * once)


def sphere_tcg_work(n: int, lane_iters):
    """(operations, bytes) of one K2/K3 call whose lanes ran ``lane_iters``
    [B] iterations: 2 n^2 + 40 n an iteration; reads Zs, xs, ws, grads,
    radii, writes etas, Hetas and the [B, 2] stats."""
    iters = np.asarray(lane_iters, np.float64).reshape(-1)
    b = iters.size
    ops = float(iters.sum()) * (2.0 * n * n + SPHERE_TCG_VEC_OPS * n)
    return ops, zs_bytes(n, iters.max(initial=0)) + F32 * (5.0 * b * n + 3.0 * b)


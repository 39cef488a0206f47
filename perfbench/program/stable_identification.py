"""StableIdentification in the port: the problem on Product(Skew(d),
SPD(d), SPD(d)).  No fused tCG kernel takes this family: RIPTRM's tCG is
the port's generic lane-masked ``truncated_cg``."""

from __future__ import annotations

import torch


def make_problem(arrays, x0, cfg, device, matmul_precision):
    from riptrm_torch.problems import stable_identification

    dtype = getattr(torch, cfg["dtype"])
    return stable_identification.make_problem(
        cfg["dim"], list(arrays["trajectories"]), arrays["constset"], tuple(x0.unbind(0)),
        h=cfg["h"], dtype=dtype, device=device, matmul_precision=matmul_precision)

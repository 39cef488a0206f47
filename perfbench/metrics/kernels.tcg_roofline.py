"""The cell's fused tCG entry at the cell's own shape (its lanes and n),
every lane running ``maxinner`` = n iterations (the solver's own cap),
unless CG's model stops improving first, as a share
of its roofline: the least time the card could take for the call's FP32
operations and bytes (``roofline_count.py``), over the measured time.
Measured after the traced window: CUDA events around a window of
back-to-back calls lasting >= 50 ms, after a warm-up, the median of three
windows.  ``by`` says which of operations or bytes bounds it."""

import statistics

import numpy as np

from perfbench.roofline_count import roofline_bound

WINDOW_S = 0.05


def _timed(call, count):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    iters = [call() for _ in range(count)]
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, iters


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    call, work = run.cell.program.tcg_call(run.cell.config, run.cell.traffic["lanes"],
                                           run.cell.config["dim"], run.device, run.seed)
    probe, _ = _timed(call, 3)
    count = max(3, int(np.ceil(3 * WINDOW_S / probe)))
    times, iters = [], None
    for _ in range(3):
        seconds, iters = _timed(call, count)
        times.append(seconds)
    per_call = statistics.median(times) / count
    ops, nbytes = work(iters[-1].cpu().numpy())
    bound_s, by = roofline_bound(ops, nbytes)
    return {"value": 100.0 * bound_s / per_call, "by": by,
            "mean_iters": float(np.mean(iters[-1].cpu().numpy()))}

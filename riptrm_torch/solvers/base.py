"""Shared solver machinery: option merging, outputs, host-side logging and
the lane-batched fixed-budget solve loop.

Counterpart of ``riptrm_tpu/solvers/base.py``.  ``host_run`` (the
single-level solvers' runner) and the wandb hooks wait for the solvers and
the experiment layer that use them (ROADMAP.md queue 1, items 10 and 12).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Output:
    """Reference ``Output``: final point, multipliers, options and log."""

    name: str
    x: Any
    ineqLagmult: Any
    eqLagmult: Any
    option: Optional[Dict]
    log: Optional[Dict]


def merge_options(default: dict, *overrides: dict) -> dict:
    """Layered option merging: defaults <- common <- solver-specific."""
    out = dict(default)
    for o in overrides:
        if o:
            out.update(o)
    return out


class LogAccumulator:
    """Per-iteration log dict of lists."""

    def __init__(self):
        self.log: Dict[str, list] = {}

    @staticmethod
    def _to_python(v):
        if v is None or isinstance(v, (str, bool, int, float)):
            return v
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        if arr.ndim == 0:
            return arr.item()
        return arr

    def add(self, iteration: int, run_time: float, *dicts):
        row = {"iteration": iteration, "time": run_time}
        for d in dicts:
            for k, v in d.items():
                row[k] = self._to_python(v)
        # Keep every column the same length: backfill keys first seen now
        # and pad keys absent from this row.
        n_prev = len(self.log["iteration"]) if "iteration" in self.log else 0
        for k, v in row.items():
            self.log.setdefault(k, [None] * n_prev).append(v)
        for col in self.log.values():
            if len(col) == n_prev:
                col.append(None)

    def as_dict(self):
        return self.log


class WallClock:
    """Wall-clock budget for the host runner."""

    def __init__(self, maxtime: float, initial_elapsed: float = 0.0):
        self.maxtime = maxtime
        self.start = time.time() - initial_elapsed
        self.excluded = 0.0

    def elapsed(self) -> float:
        return time.time() - self.start - self.excluded

    def exceeded(self) -> bool:
        return self.elapsed() >= self.maxtime


def select_lanes(mask, a, b):
    """Per-lane ``where(mask, a, b)`` over every tensor field of two states
    of the same dataclass (``mask`` [B] bool)."""
    out = {}
    for f in dataclasses.fields(a):
        ta, tb = getattr(a, f.name), getattr(b, f.name)
        m = mask.reshape(mask.shape + (1,) * (ta.ndim - 1))
        out[f.name] = torch.where(m, ta, tb)
    return type(a)(**out)


def compiled_best_while(step1, state0, target, max_steps, best0, stall_window=None,
                        stall_rtol=1e-2, track_best_state=False):
    """The lane-batched fixed-budget solve loop (the JAX package's
    ``lax.while_loop`` of the same name, as a Python loop over device
    tensors with one host check per step).

    ``step1(st) -> (new_st, res, counted, stop)``: one solver step on every
    lane, with each lane's residual, whether that residual counts toward
    the protocol best, and the solver's own stopping predicate (all [B]).
    ``best0`` [B] seeds the running minimum with the initial residual, so a
    lane whose target equals its starting residual stops at once.  The
    running minimum takes a strict ``<``, which a NaN residual never
    passes.  A lane that is done is frozen: its state and step count stay
    as they were when it stopped, while the other lanes go on.

    ``stall_window`` (opt-in, for throughput sweeps): a lane also stops
    once its best residual has not improved by a relative ``stall_rtol``
    in that many steps, so one lane stalled at its floor does not hold
    every lane to the full budget.  ``track_best_state`` (opt-in): keep,
    per lane, the state that reached the running best and return it in
    place of the final state.

    Returns (state, steps [B], done [B], best [B]).
    """
    b = best0.shape[0]
    device = best0.device
    target = torch.broadcast_to(
        torch.as_tensor(target, dtype=best0.dtype, device=device), (b,)
    )
    st, best = state0, best0
    best_st = state0
    k = torch.zeros(b, dtype=torch.int64, device=device)
    since = torch.zeros(b, dtype=torch.int64, device=device)
    done = best0 <= target
    for _ in range(max_steps):
        if bool(done.all()):
            break
        new_st, res, counted, stop = step1(st)
        improved = (~done) & counted & (res < best)
        if track_best_state:
            best_st = select_lanes(improved, new_st, best_st)
        if stall_window is not None:
            big_improve = improved & (res < (1.0 - stall_rtol) * best)
            since = torch.where(done, since,
                                torch.where(big_improve, torch.zeros_like(since), since + 1))
            stop = stop | (since >= stall_window)
        best = torch.where(improved, res, best)
        st = select_lanes(done, st, new_st)
        k = k + (~done).to(k.dtype)
        done = done | stop | (best <= target)
    return (best_st if track_best_state else st), k, done, best

"""Shared solver machinery: option merging, outputs, host-side logging,
the single-level solvers' host runner and the lane-batched fixed-budget
solve loop.

Counterpart of ``riptrm_tpu/solvers/base.py``, with its optional wandb
hooks (``maybe_wandb_init``/``_log``/``_finish``): ``wandb_logging=True``
logs the rows to wandb where the package is installed, and elsewhere warns
and turns the option off, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from riptrm_torch.config import resolve
from riptrm_torch.utils.lanes import lane_loop
from riptrm_torch.utils.spans import span


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


def _wandb():
    """Optional wandb import: disabled with a warning when absent (it is an
    optional extra, as in the reference's pip list)."""
    try:
        import wandb

        return wandb
    except ImportError:
        import warnings

        warnings.warn("wandb_logging requested but wandb is not installed; disabled.")
        return None


def maybe_wandb_init(option: dict, name: str):
    """Start a wandb run for a solver's ``run`` when ``wandb_logging`` is on;
    without wandb, warn and set the option to False."""
    if not option.get("wandb_logging", False):
        return None
    wandb = _wandb()
    if wandb is None:
        option["wandb_logging"] = False
        return None
    wandb.finish()
    # The reference's project template
    # ``${problem_name}-${problem_instance}-${problem_initialpoint}``: config
    # runs get it by interpolation, direct callers from the problem-identity
    # option keys when present.
    project = option.get("wandb_project")
    if not project:
        keys = ("problem_name", "problem_instance", "problem_initialpoint")
        if all(k in option for k in keys):
            project = "-".join(str(option[k]) for k in keys)
        else:
            project = "riptrm_torch"
    return wandb.init(
        project=project,
        name=name,
        config={k: v for k, v in option.items() if not callable(v)},
    )


def maybe_wandb_log(option: dict, row: dict):
    """Log one row's scalar entries when ``wandb_logging`` is on."""
    if not option.get("wandb_logging", False):
        return
    wandb = _wandb()
    if wandb is None:
        option["wandb_logging"] = False
        return
    wandb.log({k: v for k, v in row.items() if not isinstance(v, (list, np.ndarray))})


def maybe_wandb_finish(option: dict):
    if not option.get("wandb_logging", False):
        return
    wandb = _wandb()
    if wandb is not None:
        wandb.finish()


def lane0_to_host(d: dict) -> dict:
    """Lane 0 of every tensor value of ``d`` as a Python number (bool, int
    or float by the tensor's dtype), in ONE device->host copy; other values
    pass through."""
    keys = [k for k, v in d.items() if isinstance(v, torch.Tensor)]
    out = dict(d)
    if not keys:
        return out
    vals = torch.stack(
        [d[k].reshape(-1)[0].to(torch.float64) for k in keys]
    ).cpu().tolist()
    for k, v in zip(keys, vals):
        dt = d[k].dtype
        out[k] = bool(v) if dt == torch.bool else (
            v if dt.is_floating_point else int(v))
    return out


def host_run(*, option, state, step, evaluate, status_row, get_x, verbosity_line=None,
             stop_flag=None):
    """Shared host-driven loop of the single-level solvers (RIPM, RSQO,
    RALM) on one lane: evaluate -> log -> stop checks -> step, with the
    reference's stopping order (residual, wall clock, iteration count),
    per-step ``do_exit_on_error`` and the logging time excluded from the
    wall-clock budget.

    ``step(state) -> (state, info)``; ``evaluate(x_prev, state)`` and
    ``status_row(state, info)`` return dicts whose tensor values are read
    at lane 0 (``lane0_to_host``); ``stop_flag(state, info) -> str or
    None`` is a solver-raised stop, whose flagged row is logged before the
    exit.  Returns (final state, log dict, stop reason)."""
    log = LogAccumulator()
    clock = WallClock(option["maxtime"])
    info: dict = {}
    x_prev = get_x(state)
    iteration = 0
    stop_reason = None
    while True:
        try:
            ev = lane0_to_host(evaluate(x_prev, state))
        except Exception as e:
            if option["do_exit_on_error"]:
                print(f"Error: {e}")
                break
            raise
        run_time = 0.0 if iteration == 0 else clock.elapsed()
        # Log accumulation is host bookkeeping, not solve time.
        t_log = time.time()
        log.add(iteration, run_time, ev, lane0_to_host(status_row(state, info)))
        maybe_wandb_log(option, ev | {"time": run_time})
        clock.excluded += time.time() - t_log

        residual = ev["residual"]
        x_prev = get_x(state)
        if option.get("verbosity") and verbosity_line:
            print(verbosity_line(iteration, ev))
        if residual <= option["tolresid"]:
            stop_reason = (
                f"KKT residual tolerance reached; current residual={residual} "
                f"and tolresid={option['tolresid']}"
            )
            break
        if clock.exceeded():
            stop_reason = (
                f"Max time exceeded; runtime={clock.elapsed():.2f} and "
                f"maxtime={option['maxtime']}"
            )
            break
        if iteration >= option["maxiter"]:
            stop_reason = (
                f"Max iteration count reached; maxiter={option['maxiter']} "
                f"after {clock.elapsed():.2f} seconds"
            )
            break
        iteration += 1
        try:
            state, info = step(state)
        except Exception as e:
            if option["do_exit_on_error"]:
                print(f"Error: {e}")
                break
            raise
        if stop_flag is not None:
            reason = stop_flag(state, info)
            if reason:
                # the flagged iteration's row, logged before the exit
                ev = lane0_to_host(evaluate(x_prev, state))
                log.add(iteration, clock.elapsed(), ev,
                        lane0_to_host(status_row(state, info)))
                stop_reason = reason
                break
    return state, log.as_dict(), stop_reason


def max_abs_multiplier(*mults):
    """The maxabsLagmult log field per lane, [B]: the largest |entry| over
    the lane's multiplier vectors ([B, m] each), -inf when they are all
    empty."""
    parts = [torch.abs(m).reshape(m.shape[0], -1) for m in mults]
    allm = torch.cat(parts, dim=-1)
    if allm.shape[-1] == 0:
        return torch.full((allm.shape[0],), -math.inf, dtype=allm.dtype,
                          device=allm.device)
    return torch.amax(allm, dim=-1)


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
    ``lax.while_loop`` of the same name): ``utils/lanes.py::lane_loop``,
    eagerly a Python loop over device tensors with one host check per step,
    under tracing one ``while_loop`` operator.  Each body runs in a
    ``riptrm.step`` span (``utils/spans.py``); the check stays outside it.

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
    k = torch.zeros(b, dtype=torch.int64, device=device)
    since = torch.zeros(b, dtype=torch.int64, device=device)
    done = best0 <= target
    # best_st and since ride in the carry only where they are updated
    carry = (state0, best0, k, done) + ((state0,) if track_best_state else ()) + (
        (since,) if stall_window is not None else ())

    def running(st, best, k, done, *extra):
        return ~done.all()

    def body(_, st, best, k, done, *extra):
        with span("riptrm.step"):
            extra = list(extra)
            new_st, res, counted, stop = step1(st)
            improved = (~done) & counted & (res < best)
            if track_best_state:
                extra[0] = select_lanes(improved, new_st, extra[0])
            if stall_window is not None:
                since = extra[-1]
                big_improve = improved & (res < (1.0 - stall_rtol) * best)
                extra[-1] = since = torch.where(
                    done, since, torch.where(big_improve, torch.zeros_like(since), since + 1))
                stop = stop | (since >= stall_window)
            best = torch.where(improved, res, best)
            st = select_lanes(done, st, new_st)
            k = k + (~done).to(k.dtype)
            done = done | stop | (best <= target)
            return (st, best, k, done, *extra)

    st, best, k, done, *extra = lane_loop(running, body, carry, max_steps)
    return (extra[0] if track_best_state else st), k, done, best


def state_from_numpy(cls, d, *, scalar_field, int_fields=(), device=None, dtype=None,
                     manifold=None):
    """A solver state dataclass ``cls`` from a dict of arrays, e.g.
    ``jax.device_get(state)._asdict()`` of the JAX package's state of the
    same name.  An unbatched state becomes one lane, a vmapped one keeps
    its lanes: which it is follows from the per-lane scalar
    ``scalar_field`` (0-d or [B]).  A field that is a tuple of arrays (a
    point of a JAX ``Product`` or fixed-rank manifold) is packed by
    ``manifold.pack``.  Float fields take ``dtype`` (default: the dtype of
    ``x``), ``int_fields`` int64, boolean arrays bool; every field lands on
    ``device`` (default: the card, ``config.resolve``)."""
    batched = np.ndim(d[scalar_field]) == 1
    if dtype is None:
        x = d["x"][0] if isinstance(d["x"], (tuple, list)) else d["x"]
        dtype = torch.from_numpy(np.array(x)).dtype
    _, device = resolve(dtype, device)
    out = {}
    for f in dataclasses.fields(cls):
        if isinstance(d[f.name], (tuple, list)):
            if manifold is None:
                raise ValueError(f"{f.name} is a tuple: pass the manifold that packs it")
            parts = tuple(torch.as_tensor(np.array(a), dtype=dtype, device=device)
                          for a in d[f.name])
            out[f.name] = manifold.pack(parts if batched else tuple(a[None] for a in parts))
            continue
        a = np.array(d[f.name])  # a writable copy
        if not batched:
            a = a[None]
        if f.name in int_fields:
            out[f.name] = torch.as_tensor(a.astype(np.int64), device=device)
        elif a.dtype == bool:
            out[f.name] = torch.as_tensor(a, device=device)
        else:
            out[f.name] = torch.as_tensor(a, dtype=dtype, device=device)
    return cls(**out)


def state_to_numpy(state) -> dict:
    """Inverse of ``state_from_numpy``: the lane axis is dropped at B = 1."""
    squeeze = state.x.shape[0] == 1
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name).detach().cpu().numpy()
        out[f.name] = a[0] if squeeze else a
    return out

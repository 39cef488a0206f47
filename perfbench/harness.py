"""The benchmark's one general runner.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
runner finds every piece by name, so that a new configuration, mix, entry,
family or metric is a new file and a new entry, never an edit:

* ``configs/<config>.json`` (the file the configuration's entry names):
  the family, its sizes, precision, solver options and forcing floors;
* ``traffic/<mix>.json``: the entry of the port it drives, lanes a call,
  step budget, warm-up steps, the size of the pool of starts, the sweeps a
  traced window holds;
* ``gen/<family>.py`` (seeded NumPy inputs), ``program/<family>.py`` (the
  port's problem), ``reference/<family>.py`` (the plain float64 check),
  ``entries/<entry>.py`` (the call into the port);
* ``checks/<cell>.json``: the numbers the comparison that decides
  ``correct`` holds the cell to, each with its limit and the readings it
  was set from;
* ``metrics/<metric>.py``: one reader a metric, ``read(run)`` returning a
  number, a dict with a ``value``, or None where it finds nothing to read.

A run: the configuration's instance and a pool of starts drawn on the
host from the seed,
the problem built on the card, the kernels loaded, a warm-up at the
cell's own shapes, then a closed loop of calls (one client waiting for
each) for ``seconds``; after the window, the reference judges every
answer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import itertools
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "riptrm_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """The module in ``path``, imported by its path (a metric's file name
    may hold dots)."""
    name = "perfbench_file_" + hashlib.sha256(str(path.resolve()).encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list
    root: pathlib.Path
    checks: dict  # checks/<cell>.json

    def piece(self, kind: str, name: str):
        return load_module(self.root / "perfbench" / kind / f"{name}.py")

    @property
    def gen(self):
        return self.piece("gen", self.config["family"])

    @property
    def program(self):
        return self.piece("program", self.config["family"])

    @property
    def reference(self):
        return self.piece("reference", self.config["family"])

    @property
    def entry(self):
        return self.piece("entries", self.traffic["entry"])


def find_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its
    configuration, traffic mix and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, cell["chips"], load_json(root / config["file"]),
                load_json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json"),
                e2e, layer, root, load_json(root / "perfbench" / "checks" / f"{name}.json"))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def rng_for(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed % 2**64)


def make_inputs(cell: Cell, seed: int):
    """(instance arrays, starts [pool_sweeps, lanes, ...]) on the host.

    The instance is the configuration's own (its ``instance_seed``, as the
    upstream's dataset config fixes one): a deployment sweeps one instance
    from many starts, and the instance sets how many steps every start
    takes, so each run does the same kind of work.  The starts come from
    the run's seed, or, where the mix sets ``"starts_pool": "fixed"``,
    from the configuration: the pool is then drawn from the stream
    ``SeedSequence(instance_seed, spawn_key=(0,))`` (the first child of
    the instance seed, independent of the instance's own draw from
    ``instance_seed``), and the run's seed only draws one permutation of
    the lanes for each sweep of the pool.  A lockstep sweep runs as long
    as its slowest lane, so with a fixed pool every run's sweeps do the
    same work whatever the seed."""
    cfg, mix = cell.config, cell.traffic
    arrays = cell.gen.instance(rng_for(cfg["instance_seed"]), cfg)
    pool, lanes = mix["pool_sweeps"], mix["lanes"]
    if mix.get("starts_pool") not in (None, "fixed"):
        raise ValueError(f"starts_pool {mix['starts_pool']!r}: only \"fixed\" is known")
    if mix.get("starts_pool") == "fixed":
        stream = np.random.SeedSequence(cfg["instance_seed"] % 2**64, spawn_key=(0,))
        starts = cell.gen.starts(np.random.default_rng(stream), cfg, pool * lanes)
        starts = starts.reshape(pool, lanes, *starts.shape[1:])
        order = rng_for(seed)
        return arrays, np.stack([sweep[order.permutation(lanes)] for sweep in starts])
    starts = cell.gen.starts(rng_for(seed), cfg, pool * lanes)
    return arrays, starts.reshape(pool, lanes, *starts.shape[1:])


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Call:
    """One call of the window: a sweep of ``lanes`` starts, or one solve."""

    index: int
    start: float
    end: float
    x: object  # answers [lanes, ...] on the device
    y: object  # their inequality multipliers [lanes, m]
    steps: object  # [lanes]
    residual: object  # the program's own KKT residuals [lanes]

    @property
    def seconds(self) -> float:
        return self.end - self.start


def closed_loop(run, pool, ys, seconds: float, sync, max_calls=None):
    """Calls back to back, each on the next starts of the pool (cycled).
    A call starts only while the time left is at least the mean call time
    so far, so the window ends with the last call and drops no work.
    Returns (calls, window seconds from the first start to the last end)."""
    calls, t_first = [], time.perf_counter()
    while max_calls is None or len(calls) < max_calls:
        now = time.perf_counter()
        if calls and seconds - (now - t_first) < (now - t_first) / len(calls):
            break
        i = len(calls)
        t0 = time.perf_counter()
        x, y, steps, residual = run(pool[i % pool.shape[0]], ys)
        sync()
        calls.append(Call(i, t0, time.perf_counter(), x, y, steps, residual))
    return calls, calls[-1].end - t_first


# ---------------------------------------------------------------------------
# the tCG step, recorded where the program produces it
# ---------------------------------------------------------------------------
class TcgProbe:
    """Records every call of the family's fused tCG entry (``TCG_ENTRY``
    of its ``program`` module, a function of ``riptrm_torch.ops.kernels``)
    made during the window's first call: the entry's arguments and the
    step it returned, each lane-indexed tensor cut to the ``sample`` lanes
    (sorted indices, drawn from the run's seed; those a call has), the
    shared Zs whole.  Every window has a first call, so every run records
    the same work whatever its seed; the sample goes to the device once,
    so a record waits for nothing on the device.  The solver looks the
    entry up on the module at each step, so the recorder sits there during
    that call, around whatever the module holds (the control's stand-in
    too)."""

    def __init__(self, name: str, sample):
        self.name, self.sample, self.records = name, sample, []

    def wrap(self, run):
        from riptrm_torch.ops import kernels

        calls = itertools.count()

        def probed(xs, ys):
            if next(calls) > 0:
                return run(xs, ys)
            entry = getattr(kernels, self.name)
            sample = self.sample.to(xs.device)

            def record(*args, **kwargs):
                out = entry(*args, **kwargs)
                lanes = sample[:int((self.sample < out[0].shape[0]).sum())]
                self.records.append(((args[0], *(a[lanes] for a in args[1:])), kwargs,
                                     tuple(o[lanes] for o in out)))
                return out

            setattr(kernels, self.name, in_place_of(entry, record))
            try:
                return run(xs, ys)
            finally:
                setattr(kernels, self.name, entry)

        return probed


def tcg_sample(seed: int, traffic: dict):
    """The lanes whose tCG steps the probe keeps: ``tcg_sample_lanes`` of
    the mix (all lanes where it is absent or larger), drawn from the seed,
    sorted."""
    import torch

    lanes = traffic["lanes"]
    count = min(lanes, traffic.get("tcg_sample_lanes", lanes))
    picked = np.sort(rng_for(seed + 1).choice(lanes, size=count, replace=False))
    return torch.as_tensor(picked, dtype=torch.int64)


def in_place_of(entry, fn):
    """``fn`` as a function that shares ``entry``'s attributes, to be set
    in its place on its module: the port counts a kernel's launches in
    an attribute of its entry, looked up on the module."""
    def call(*args, **kwargs):
        return fn(*args, **kwargs)

    call.__dict__ = entry.__dict__
    return call


@contextlib.contextmanager
def tcg_stand_in(cell: Cell):
    """The control's tCG: the family's fused tCG entry replaced by the
    reference's tCG in float32 with TF32 products, for the whole run."""
    from riptrm_torch.ops import kernels

    name = cell.program.TCG_ENTRY
    entry = getattr(kernels, name)
    setattr(kernels, name, in_place_of(entry, cell.reference.tcg_stand_in))
    try:
        yield
    finally:
        setattr(kernels, name, entry)


# ---------------------------------------------------------------------------
# the comparison that decides ``correct``
# ---------------------------------------------------------------------------
def judge(cell: Cell, arrays, calls, pool, records):
    """Every answer of the window, and the recorded tCG steps, against the
    float64 reference.

    Per lane: the reference's KKT residual r at the answer, the program's
    own report p, and whether the answer is bitwise its start.  Numbers
    compared (those the cell's ``checks`` file names, each with its limit):
    ``resid_gap``, the largest |p - r| / max(r, tol) (a lane where only one
    of the two is finite reads inf); ``lane_resid_over_tol``, the worst
    lane's p / tol (inf where r or p is not finite): the configuration's
    tolresid is the solver's own stopping test, so it holds p, and
    ``resid_gap`` holds p to r (a lane that stops just under tol in
    float32 can read a hair above it in float64); ``unmoved_lanes``, the
    answers that are their start unchanged; ``tcg_heta_gap``, the largest
    gap over the recorded tCG calls and their sampled lanes between the
    Hessian image the program returned with its step and the reference's
    Hessian applied to that step (inf where no call was recorded).
    ``failed`` counts lanes by the same rule: a lane fails where its p is
    over tol or not finite, where r is not finite, or where its own
    |p - r| / max(r, tol) is over the ``resid_gap`` limit.  Returns
    (attempted, failed, checks)."""
    import torch

    cfg = cell.config
    tol = cfg["solver"]["tolresid"]
    shape = tuple(pool.shape[1:])
    r_ref, r_prog, unmoved = [], [], []
    for call in calls:
        if tuple(call.x.shape) != shape or tuple(call.residual.shape) != shape[:1]:
            raise ValueError(f"call {call.index}: answers {tuple(call.x.shape)}, "
                             f"residuals {tuple(call.residual.shape)}; expected {shape}")
        x = call.x.to(torch.float64)
        r_ref.append(cell.reference.residual(arrays, cfg, x, call.y.to(torch.float64)).cpu())
        r_prog.append(call.residual.to(torch.float64).cpu())
        start = pool[call.index % pool.shape[0]]
        unmoved.append(torch.all((call.x == start).flatten(1), dim=1).cpu())
    r_ref = torch.cat(r_ref).numpy()
    r_prog = torch.cat(r_prog).numpy()
    unmoved = torch.cat(unmoved).numpy()
    fin_ref, fin_prog = np.isfinite(r_ref), np.isfinite(r_prog)
    with np.errstate(invalid="ignore"):
        gap = np.abs(r_prog - r_ref) / np.maximum(r_ref, tol)
    gap = np.where(fin_ref & fin_prog, gap, np.where(fin_ref | fin_prog, np.inf, 0.0))
    over = np.where(fin_ref & fin_prog, r_prog / tol, np.inf)
    spec = cell.checks["numbers"]
    numbers = {"resid_gap": float(gap.max()), "lane_resid_over_tol": float(over.max()),
               "unmoved_lanes": float(unmoved.sum())}
    if "tcg_heta_gap" in spec:
        gaps = [cell.reference.tcg_gap(arrays, cfg, *record) for record in records]
        numbers["tcg_heta_gap"] = max((float(g.max()) for g in gaps), default=np.inf)
    checks = {name: {"value": numbers[name], "limit": spec[name]["limit"]} for name in spec}
    failed = int(np.sum(~(r_prog <= tol) | ~fin_ref | (gap > spec["resid_gap"]["limit"])))
    return len(r_ref), failed, checks


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load
    (compared whole: ``riptrm_torch`` is not ``riptrm_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    seed: int
    device: object
    calls: list
    window_s: float
    setup_s: float
    trace: object = None  # perfbench.trace.Trace of a traced run

    @property
    def steps(self):
        """Lockstep steps of each call: the most any of its lanes took."""
        return [int(np.max(c.steps)) for c in self.calls]


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t_process0: float,
             control=False, rehearse=False, wrap=None):
    """One run of ``cell``; returns the result line as a dict.

    ``control`` runs the cell's lower-precision control: the program's
    own TF32 path switched on and, where the cell's checks compare the
    tCG step, the kernel (which has no TF32 path) replaced by the
    reference's tCG in TF32.  The reference always judges in float64.
    ``rehearse`` (CPU tests only) reports no metric.  ``wrap(run, pool) ->
    run`` plants a fault under the timed path (tests only)."""
    with contextlib.ExitStack() as stack:
        if control and "tcg_heta_gap" in cell.checks["numbers"]:
            stack.enter_context(tcg_stand_in(cell))
        return _run_cell(cell, seed, seconds, trace, device, t_process0, control, rehearse,
                         wrap)


def _run_cell(cell, seed, seconds, trace, device, t_process0, control, rehearse, wrap):
    import torch

    cfg, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    precision = "high" if control else cfg["matmul_precision"]
    torch.set_float32_matmul_precision(precision)
    stages = {"start": time.perf_counter() - t_process0}

    def stage(name):
        sync()
        stages[name] = time.perf_counter() - t_process0

    arrays, starts = make_inputs(cell, seed)
    stage("inputs")
    dtype = getattr(torch, cfg["dtype"])
    pool = torch.as_tensor(starts, dtype=dtype).to(device)
    problem = cell.program.make_problem(arrays, pool[0, 0], cfg, device, precision)
    ys = torch.ones(traffic["lanes"], problem.num_ineq, dtype=dtype, device=device)
    stage("problem")
    if cuda and traffic.get("fused_tcg"):
        from riptrm_torch.ops import _build

        _build.load()
    stage("kernels")
    entry = cell.entry
    warm = entry.build(problem, cfg, traffic, traffic["warmup_steps"])
    run = entry.build(problem, cfg, traffic, traffic["max_steps"])
    if wrap is not None:
        run = wrap(run, pool)
    probe = None
    if "tcg_heta_gap" in cell.checks["numbers"]:
        probe = TcgProbe(cell.program.TCG_ENTRY, tcg_sample(seed, traffic))
        run = probe.wrap(run)
    warm(pool[0], ys)
    stage("warmup")
    setup_s = stages["warmup"]
    print("setup " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    calls, window_s = closed_loop(run, pool, ys, seconds, sync,
                                  traffic["trace_calls"] if trace else None)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    for call in calls:
        call.steps = call.steps.cpu().numpy()

    out_run = Run(cell, seed, device, calls, window_s, setup_s)
    print(f"window {window_s:.3f} s, {len(calls)} calls, lockstep steps a call "
          f"{out_run.steps}, seconds a call {[round(c.seconds, 3) for c in calls]}",
          file=sys.stderr)
    if prof is not None:
        from perfbench.trace import Trace

        t0 = time.perf_counter()
        out_run.trace = Trace.from_profiler(prof)
        del prof
        print(f"trace: {len(out_run.trace.device)} device activities, "
              f"{len(out_run.trace.ops)} host operators, read in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    metrics = {}
    if not rehearse:
        for m in (cell.per_layer if trace else cell.metrics):
            value = cell.piece("metrics", m["name"]).read(out_run)
            if value is None:
                continue
            value = value if isinstance(value, dict) else {"value": value}
            metrics[m["name"]] = {"value": float(value.pop("value")), "unit": m["unit"],
                                  **value}

    # the program's state goes before the reference runs
    records = probe.records if probe is not None else []
    del run, warm, problem, ys, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted, failed, checks = judge(cell, arrays, calls, pool, records)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics}
    if rehearse:
        result["device"] = {"platform": "cpu", "kind": "rehearsal", "count": 0,
                            "memory_peak_bytes": 0}
    else:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": cell.chips, "memory_peak_bytes": peak}
    if out_run.trace is not None:
        result["device"] |= {"busy_s": out_run.trace.busy_s(), "window_s": window_s}
        result["breakdown"] = {"device_ops": out_run.trace.top_device_ops(),
                               "idle_gaps": out_run.trace.idle_by_host_op()}
    result["checks"] = checks
    return result

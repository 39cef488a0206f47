"""The port's profiler spans (``riptrm_torch/utils/spans.py``) and the
benchmark's readers of them (``perfbench/metrics/``), on the CPU under
torch.profiler, read through ``perfbench.trace.Trace``: the spans' nesting
under ``riptrm.sweep`` and ``riptrm.step``, one ``riptrm.step`` a lockstep
step, one line-search trial a host check of the line search, one
``riptrm.tcg.iteration`` a lockstep iteration of the generic tCG on
StableIdentification, nothing opened with the profiler off or in an
exported program, and each metric reader on a run built from a CPU
trace."""

import collections
import functools
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness
from perfbench.trace import Trace
from riptrm_torch.parallel.sweep import batched_riptrm_solve, batched_solver_sweep
from riptrm_torch.problems import nonneg_pca, stable_identification
from riptrm_torch.solvers import riptrm
from riptrm_torch.utils import spans

torch.set_num_threads(1)
N, B = 8, 4
METRICS = pathlib.Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
TCG = {"TRS_solver": "tCG", "second_order_stationarity": False}
# solver, its options, the spans each step must hold
CASES = {
    "RIPM": ("RIPM", {"maxiter": 30, "tolresid": 1e-6},
             ("riptrm.ripm.kkt", "riptrm.ripm.materialize", "riptrm.ripm.newton_solve",
              "riptrm.ripm.line_search", "riptrm.residual")),
    "RIPM-krylov": ("RIPM", {"maxiter": 10, "tolresid": 1e-6, "KrylovIterMethod": True},
                    ("riptrm.ripm.kkt", "riptrm.ripm.krylov", "riptrm.ripm.line_search")),
    "RIPTRM-tCG": ("RIPTRM", {"maxiter": 30, "tolresid": 1e-6} | TCG,
                   ("riptrm.riptrm.barrier", "riptrm.riptrm.direction", "riptrm.riptrm.trial",
                    "riptrm.riptrm.evaluation")),
    "RIPTRM-exact": ("RIPTRM", {"maxiter": 10, "tolresid": 1e-6},
                     ("riptrm.riptrm.barrier", "riptrm.riptrm.materialize", "riptrm.riptrm.trs",
                      "riptrm.riptrm.trial", "riptrm.riptrm.evaluation")),
    "RSQO": ("RSQO", {"maxiter": 10, "tolresid": 1e-8},
             ("riptrm.rsqo.regularize", "riptrm.rsqo.qp", "riptrm.rsqo.line_search")),
    "RALM": ("RALM", {"maxiter": 5, "tolresid": 1e-4}, ("riptrm.ralm.line_search",)),
}


def _instance(dtype=torch.float64):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, N))
    xs = np.abs(rng.standard_normal((B, N)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    xs = torch.tensor(xs, dtype=dtype)
    problem = nonneg_pca.make_problem(torch.tensor(a @ a.T / N), xs[0], dtype=dtype,
                                      device="cpu")
    return problem, xs, torch.ones(B, N, dtype=dtype)


def _traced(run, *args):
    """(``run(*args)``, the Trace of one profiler window around it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(*args)
    return out, Trace.from_profiler(prof)


def _sweep(case):
    solver, option, _ = CASES[case]
    problem, xs, ys = _instance()
    return _traced(batched_solver_sweep(problem, solver, option, 200), xs, ys)


def _named(trace, name):
    return [i for i, op in trace.ops.items() if op.name == name]


def _parent(trace, i):
    return trace.ops[trace.ops[i].parent].name


def _inside(trace, i, name):
    """Whether operator ``i`` ran inside a span or operator named ``name``."""
    return name in list(trace.ancestors(i))[1:]


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_sweep_step_phase(case):
    """``riptrm.sweep`` holds its init, its steps and its residual; each
    step holds the solver's phase spans."""
    _, trace = _sweep(case)
    (sweep,) = _named(trace, "riptrm.sweep")
    assert trace.ops[sweep].parent == 0
    for name in ("riptrm.sweep.init", "riptrm.sweep.residual"):
        assert [_parent(trace, i) for i in _named(trace, name)] == ["riptrm.sweep"]
    steps = _named(trace, "riptrm.step")
    assert steps and {_parent(trace, i) for i in steps} == {"riptrm.sweep"}
    for name in CASES[case][2]:
        found = _named(trace, name)
        assert found, name
        assert all(_inside(trace, i, "riptrm.step") for i in found), name


@pytest.mark.parametrize("case", ["RIPM", "RIPTRM-tCG"])
def test_step_spans_equal_lockstep_steps(case):
    """One ``riptrm.step`` a body of the lockstep loop: as many as the most
    steps any lane took."""
    (_, _, k, _), trace = _sweep(case)
    assert len(_named(trace, "riptrm.step")) == int(k.max()) > 0


def test_ls_trials_equal_line_search_host_checks():
    """Each trial of RIPM's line search is followed by one host check of
    the lane loop, so the ``riptrm.ripm.ls_trial`` spans equal the
    ``aten::_local_scalar_dense`` reads inside ``riptrm.ripm.line_search``,
    and no read sits inside a trial."""
    (_, _, k, _), trace = _sweep("RIPM")
    trials = _named(trace, "riptrm.ripm.ls_trial")
    assert {_parent(trace, i) for i in trials} == {"riptrm.ripm.line_search"}
    reads = _named(trace, "aten::_local_scalar_dense")
    in_ls = [i for i in reads if _inside(trace, i, "riptrm.ripm.line_search")]
    assert len(trials) == len(in_ls) > int(k.max())
    assert not any(_inside(trace, i, "riptrm.ripm.ls_trial") for i in reads)


def test_checkpointed_sweep_spans(tmp_path):
    """The checkpointed sweep's segments run inside one ``riptrm.sweep``."""
    from riptrm_torch.parallel.sweep import run_sweep_checkpointed

    problem, xs, ys = _instance()
    option = {"maxiter": 30, "tolresid": 1e-6} | TCG
    (_, _, k, _), trace = _traced(
        lambda: run_sweep_checkpointed(problem, option, xs, ys, max_steps=40, segment_steps=15,
                                       checkpoint_path=str(tmp_path / "ck.pt")))
    (sweep,) = _named(trace, "riptrm.sweep")
    assert trace.ops[sweep].parent == 0
    assert _named(trace, "riptrm.sweep.init")
    steps = _named(trace, "riptrm.step")
    assert steps and all(_inside(trace, i, "riptrm.sweep") for i in steps)
    assert all(_inside(trace, i, "riptrm.sweep") for i in _named(trace, "riptrm.sweep.residual"))


def test_no_range_opened_with_profiler_off(monkeypatch):
    """With the profiler off a span opens nothing: the range function,
    patched to raise, is never called by a whole sweep; with the profiler
    on the same patch is reached."""
    def refuse(name):
        raise AssertionError(f"a range was opened: {name}")

    monkeypatch.setattr(spans, "_range", refuse)
    problem, xs, ys = _instance()
    run = batched_solver_sweep(problem, "RIPM", CASES["RIPM"][1], 200)
    _, _, k, res = run(xs, ys)
    assert int(k.max()) > 0 and torch.all(torch.isfinite(res))
    b_run = batched_riptrm_solve(problem, CASES["RIPTRM-tCG"][1], 200)
    b_run(xs, ys)
    with pytest.raises(AssertionError, match="riptrm.sweep"):
        with profile(activities=[ProfilerActivity.CPU]):
            run(xs, ys)


def test_exported_sweep_holds_no_profiler_node(tmp_path):
    """A sweep exported while the profiler records: the traced program
    holds no profiler operator (the spans stand aside under tracing), and
    it runs."""
    from riptrm_torch.experiment.export_artifact import export_sweep, load_sweep

    problem, xs, ys = _instance()
    path = str(tmp_path / "ripm.pt2")
    with profile(activities=[ProfilerActivity.CPU]):
        export_sweep(problem, "RIPM", {"maxiter": 10, "tolresid": 1e-6}, path, batch=B,
                     max_steps=20, device="cpu")
    targets = collections.Counter()
    for module in torch.export.load(path).graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            targets.update(str(n.target) for n in module.graph.nodes if n.op == "call_function")
    assert targets["while_loop"] >= 1
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    run, _ = load_sweep(path)
    assert torch.all(torch.isfinite(run(xs, ys)[3]))


SID_STARTS, SID_STEPS = "abcd", 8
TCG_READERS = ("tcg.pct_of_window", "tcg.iters_per_step", "tcg.hvp_pct_of_window",
               "tcg.syncs_per_step", "riptrm.retract_pct_of_window", "tcg.hvp_kernel_share",
               "spd.metric_solve_pct_of_window", "spd.solve_kernel_share")


def _sid_instance(dtype=torch.float64):
    """StableIdentification's shipped instance 1 (Product(Skew(5), SPD(5),
    SPD(5)), 16 constraints) with its starts a-d as lanes, float64."""
    path = str(pathlib.Path(__file__).resolve().parents[1] / "dataset/StableIdentification/1")
    problems = [stable_identification.load_problem(path, s, dtype=dtype, device="cpu")
                for s in SID_STARTS]
    xs = torch.stack([p.x0 for p in problems])
    return problems[0], xs, torch.ones(len(SID_STARTS), problems[0].num_ineq, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _sid_sweep():
    """A traced RIPTRM tCG sweep of StableIdentification through the
    generic tCG: ((x, y, steps, residuals), its Trace, and each step's
    lockstep tCG iterations, the most any lane's info reports)."""
    problem, xs, ys = _sid_instance()
    iters = []
    make_step = riptrm.make_step

    def recording(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state):
            new_state, info = step(state)
            iters.append(int(info["tcg_iters"].max()))
            return new_state, info

        return run

    with mock.patch.object(riptrm, "make_step", recording):
        run = batched_riptrm_solve(problem, {"maxiter": 30, "tolresid": 1e-8} | TCG, SID_STEPS)
    (state, k, res), trace = _traced(run, xs, ys)
    return (state.x, state.y, k, res), trace, iters


def _run_from(case):
    """A ``harness.Run`` of one call built from a CPU trace of a sweep."""
    (x, y, k, res), trace = _sid_sweep()[:2] if case == "SID" else _sweep(case)
    call = harness.Call(0, 0.0, 1.0, x, y, k.numpy(), res)
    return harness.Run(None, 0, torch.device("cpu"), [call], 1.0, 0.0, trace)


def _read(name, run):
    return harness.load_module(METRICS / f"{name}.py").read(run)


@pytest.mark.parametrize("name,device_only", [
    ("ripm.materialize_pct_of_window", True),
    ("ripm.linesearch_pct_of_window", True),
    ("ripm.ls_trials_per_step", False),
    ("host.syncs_per_step", False),
    ("ripm.newton_solve_pct_of_window", True),
    ("tcg.pct_of_window", True),
    ("tcg.iters_per_step", False),
    ("tcg.hvp_pct_of_window", True),
    ("tcg.syncs_per_step", False),
    ("riptrm.retract_pct_of_window", True),
    ("spd.metric_solve_pct_of_window", True),
])
def test_metric_readers_on_a_cpu_trace(name, device_only):
    """On a CPU trace of a RIPM sweep (of a StableIdentification RIPTRM
    sweep for the generic tCG's and the retraction's readers), each reader
    gives a finite number, or None where it reads device time (a CPU trace
    has no device events); on an untraced run, None."""
    run = _run_from("SID" if name in TCG_READERS else "RIPM")
    value = _read(name, run)
    if device_only:
        assert value is None
    else:
        assert value is not None and np.isfinite(value) and value > 0
    run.trace = None
    assert _read(name, run) is None


def _innermost_span(trace, i):
    return next(name for name in trace.ancestors(i) if name.startswith("riptrm."))


def test_counts_per_step_match_the_trace():
    """``ripm.ls_trials_per_step`` is the trials over the lockstep steps;
    ``host.syncs_per_step`` the reads of device values inside the sweep's
    span over the steps: one loop check a step and the last, the line
    search's checks, and whatever the phases' operators read."""
    run = _run_from("RIPM")
    trace, steps = run.trace, sum(run.steps)
    trials = len(_named(trace, "riptrm.ripm.ls_trial"))
    assert _read("ripm.ls_trials_per_step", run) == pytest.approx(trials / steps)
    reads = _named(trace, "aten::_local_scalar_dense")
    by_span = collections.Counter(_innermost_span(trace, i) for i in reads)
    assert by_span["riptrm.sweep"] == steps + 1
    assert by_span["riptrm.ripm.line_search"] == trials
    assert _read("host.syncs_per_step", run) == pytest.approx(len(reads) / steps)


def test_metric_readers_without_spans_read_nothing(monkeypatch):
    """A trace with no span of the program (the parent commit's) gives None
    from every new reader, and raises nothing."""
    problem, xs, ys = _instance()
    run_fn = batched_solver_sweep(problem, "RIPM", CASES["RIPM"][1], 200)
    monkeypatch.setattr(spans, "_range", lambda name: spans._OFF)
    (x, y, k, res), trace = _traced(run_fn, xs, ys)
    assert not [op for op in trace.ops.values() if op.name.startswith("riptrm.")]
    run = harness.Run(None, 0, torch.device("cpu"),
                      [harness.Call(0, 0.0, 1.0, x, y, k.numpy(), res)], 1.0, 0.0, trace)
    for name in ("ripm.materialize_pct_of_window", "ripm.linesearch_pct_of_window",
                 "ripm.ls_trials_per_step", "host.syncs_per_step",
                 "ripm.newton_solve_pct_of_window", "ripm.dense_solve_kernel_share"):
        assert _read(name, run) is None, name


@pytest.mark.parametrize("dtype,share", [(torch.float32, 1.0), (torch.float64, None)],
                         ids=["f32", "f64"])
def test_dense_solve_kernel_share(dtype, share):
    """``ripm.dense_solve_kernel_share`` reads one riptrm::dense_solve inside
    every ``riptrm.ripm.newton_solve`` span of a float32 RIPM sweep, and
    None where the library solves (float64)."""
    problem, xs, ys = _instance(dtype)
    (x, y, k, res), trace = _traced(batched_solver_sweep(problem, "RIPM", CASES["RIPM"][1],
                                                         200), xs, ys)
    run = harness.Run(None, 0, torch.device("cpu"),
                      [harness.Call(0, 0.0, 1.0, x, y, k.numpy(), res)], 1.0, 0.0, trace)
    assert len(_named(trace, "riptrm.ripm.newton_solve")) == int(k.max())
    assert _read("ripm.dense_solve_kernel_share", run) == share


@pytest.mark.parametrize("dtype,share", [(torch.float32, 1.0), (torch.float64, None)],
                         ids=["f32", "f64"])
def test_tcg_hvp_kernel_share(dtype, share):
    """``tcg.hvp_kernel_share`` reads one riptrm::stableid_hvp inside every
    ``riptrm.tcg.hvp`` span of a float32 StableIdentification RIPTRM sweep,
    and None where the HVP is composed (float64)."""
    problem, xs, ys = _sid_instance(dtype)
    run_fn = batched_riptrm_solve(problem, {"maxiter": 30, "tolresid": 1e-8} | TCG, 3)
    (state, k, res), trace = _traced(run_fn, xs, ys)
    run = harness.Run(None, 0, torch.device("cpu"),
                      [harness.Call(0, 0.0, 1.0, state.x, state.y, k.numpy(), res)], 1.0, 0.0,
                      trace)
    hvps = _named(trace, "riptrm.tcg.hvp")
    ops = _named(trace, "riptrm::stableid_hvp")
    assert hvps and len(ops) == (len(hvps) if share else 0)
    assert all(_parent(trace, i) == "riptrm.tcg.hvp" for i in ops)
    assert _read("tcg.hvp_kernel_share", run) == share


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_spd_solve_kernel_share(dtype):
    """``spd.solve_kernel_share`` on a StableIdentification RIPTRM tCG
    sweep: in float32 one riptrm::spd_cho_solve a Cholesky solve, and the
    library's triangular solves only ``dist``'s congruences in the
    evaluation (two a step, two solves each), so the share is the
    operator's calls over those calls plus one a congruence; None in
    float64, where the library solves."""
    problem, xs, ys = _sid_instance(dtype)
    run_fn = batched_riptrm_solve(problem, {"maxiter": 30, "tolresid": 1e-8} | TCG, 3)
    (state, k, res), trace = _traced(run_fn, xs, ys)
    run = harness.Run(None, 0, torch.device("cpu"),
                      [harness.Call(0, 0.0, 1.0, state.x, state.y, k.numpy(), res)], 1.0, 0.0,
                      trace)
    ops = _named(trace, "riptrm::spd_cho_solve")
    solves = _named(trace, "aten::linalg_solve_triangular")
    assert not any(_inside(trace, i, "aten::linalg_solve_triangular") for i in solves)
    if dtype == torch.float64:
        assert not ops and solves
        assert _read("spd.solve_kernel_share", run) is None
        return
    steps = int(k.max())
    assert len(solves) == 4 * steps
    assert all(_inside(trace, i, "riptrm.riptrm.evaluation") for i in solves)
    assert ops and not any(_inside(trace, i, "riptrm::spd_cho_solve") for i in ops)
    assert _read("spd.solve_kernel_share", run) == pytest.approx(
        len(ops) / (len(ops) + 2 * steps))


def test_spd_readers_on_device_events():
    """The SPD metric's readers on a trace built by hand: device time
    launched inside either implementation of the solve (at any depth)
    over the window, and the operator's calls over those calls plus half
    the library's outermost triangular solves."""
    from perfbench.trace import DeviceEvent, HostOp

    ops = {1: HostOp("aten::linalg_solve_triangular", 0.0, 1.0, 0),
           2: HostOp("aten::copy_", 0.1, 0.2, 1),
           3: HostOp("riptrm.tcg", 1.0, 3.0, 0),
           4: HostOp("riptrm::spd_cho_solve", 1.0, 1.2, 3),
           5: HostOp("aten::mul", 2.0, 2.1, 3),
           6: HostOp("aten::linalg_solve_triangular", 2.2, 2.3, 3),
           7: HostOp("aten::linalg_solve_triangular", 2.2, 2.3, 6)}
    device = [DeviceEvent("trsm", 0.1, 0.6, 2), DeviceEvent("spd_solve", 1.0, 1.25, 4),
              DeviceEvent("mul", 2.0, 3.0, 5), DeviceEvent("trsm", 2.2, 2.45, 7)]
    run = harness.Run(None, 0, torch.device("cpu"), [], 10.0, 0.0, Trace(device, ops))
    assert _read("spd.metric_solve_pct_of_window", run) == pytest.approx(10.0)
    assert _read("spd.solve_kernel_share", run) == pytest.approx(1 / (1 + 2 / 2))
    del ops[4]
    assert _read("spd.solve_kernel_share", run) is None


def test_tcg_iteration_spans_equal_lockstep_iterations():
    """On StableIdentification (no fused kernel takes its tCG), each step
    holds one ``riptrm.tcg`` in its direction, with one
    ``riptrm.tcg.iteration`` a lockstep iteration: as many as the most
    iterations any lane's info reports, summed over the steps; one
    ``riptrm.tcg.hvp`` in each iteration; one ``riptrm.riptrm.retract`` in
    each trial."""
    (_, _, k, _), trace, iters = _sid_sweep()
    steps = int(k.max())
    assert steps == len(iters) == SID_STEPS and all(i > 0 for i in iters)
    tcgs = _named(trace, "riptrm.tcg")
    assert len(tcgs) == steps
    assert {_parent(trace, i) for i in tcgs} == {"riptrm.riptrm.direction"}
    its = _named(trace, "riptrm.tcg.iteration")
    assert len(its) == sum(iters)
    assert {_parent(trace, i) for i in its} == {"riptrm.tcg"}
    hvps = _named(trace, "riptrm.tcg.hvp")
    assert len(hvps) == len(its)
    assert {_parent(trace, i) for i in hvps} == {"riptrm.tcg.iteration"}
    assert all(_inside(trace, i, "riptrm.tcg") for i in hvps)
    retracts = _named(trace, "riptrm.riptrm.retract")
    assert len(retracts) == steps
    assert {_parent(trace, i) for i in retracts} == {"riptrm.riptrm.trial"}


def test_tcg_syncs_are_the_loop_checks():
    """``tcg.syncs_per_step`` reads the generic tCG's host checks: one a
    lockstep iteration and one that finds every lane done (none after the
    loop's cap, none inside an iteration: the SPD metric's solves read no
    device value), over the lockstep steps; ``tcg.iters_per_step`` the
    iterations over the steps."""
    (_, _, k, _), trace, iters = _sid_sweep()
    run = _run_from("SID")
    reads = [i for i in _named(trace, "aten::_local_scalar_dense")
             if _inside(trace, i, "riptrm.tcg")]
    maxinner = _sid_instance()[0].manifold.dim
    assert len(reads) == sum(min(i + 1, maxinner) for i in iters)
    assert not any(_inside(trace, i, "riptrm.tcg.iteration") for i in reads)
    steps = int(k.max())
    assert _read("tcg.syncs_per_step", run) == pytest.approx(len(reads) / steps)
    assert _read("tcg.iters_per_step", run) == pytest.approx(sum(iters) / steps)


@pytest.mark.parametrize("where", ["profiler_off", "exported"])
def test_tcg_spans_stand_aside(where, monkeypatch, tmp_path):
    """The generic tCG's and the retraction's spans open nothing with the
    profiler off (the range function, patched to raise, is never called by
    a StableIdentification sweep), and an exported RIPTRM tCG sweep
    (NonnegPCA's, through the same generic tCG: a quicker export) holds no
    profiler node."""
    option = {"maxiter": 30, "tolresid": 1e-8} | TCG
    if where == "profiler_off":
        def refuse(name):
            raise AssertionError(f"a range was opened: {name}")

        problem, xs, ys = _sid_instance()
        monkeypatch.setattr(spans, "_range", refuse)
        _, k, res = batched_riptrm_solve(problem, option, 3)(xs, ys)
        assert int(k.max()) == 3 and torch.all(torch.isfinite(res))
        return
    from riptrm_torch.experiment.export_artifact import export_sweep, load_sweep

    problem, xs, ys = _instance()
    path = str(tmp_path / "riptrm.pt2")
    with profile(activities=[ProfilerActivity.CPU]):
        export_sweep(problem, "RIPTRM", option, path, batch=B, max_steps=3, device="cpu")
    targets = collections.Counter()
    for module in torch.export.load(path).graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            targets.update(str(n.target) for n in module.graph.nodes if n.op == "call_function")
    assert targets["while_loop"] >= 2  # the sweep's loop and the tCG's
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    run, _ = load_sweep(path)
    assert torch.all(torch.isfinite(run(xs, ys)[3]))


def test_tcg_readers_without_spans_read_nothing(monkeypatch):
    """A StableIdentification trace with no span of the program (the
    parent commit's) gives None from every generic-tCG reader."""
    problem, xs, ys = _sid_instance()
    run_fn = batched_riptrm_solve(problem, {"maxiter": 30, "tolresid": 1e-8} | TCG, 2)
    monkeypatch.setattr(spans, "_range", lambda name: spans._OFF)
    (state, k, res), trace = _traced(run_fn, xs, ys)
    assert not [op for op in trace.ops.values() if op.name.startswith("riptrm.")]
    run = harness.Run(None, 0, torch.device("cpu"),
                      [harness.Call(0, 0.0, 1.0, state.x, state.y, k.numpy(), res)], 1.0, 0.0,
                      trace)
    for name in TCG_READERS:
        assert _read(name, run) is None, name

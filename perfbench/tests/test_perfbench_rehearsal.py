"""Whole runs of every mix on the CPU at a tiny size (each configuration
at its ``rehearsal`` sizes, at most 4 lanes a call), the command's last
line, and a configuration, mix and metric, and a whole new family, added
as new files only."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import REPO, held_back, make_tiny_root

BENCH_CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
CELLS = BENCH_CELLS + [w["name"] for w in held_back()]  # rehearsed in the tiny copy
SEED = 2**31 + 99
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def rehearse(root, name, seconds=2.0, trace=False, wrap=None, seed=SEED):
    cell = harness.find_cell(name, root)
    return harness.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                            device=torch.device("cpu"), t_process0=time.perf_counter(),
                            rehearse=True, wrap=wrap)


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_is_correct(tiny_root, name):
    out = rehearse(tiny_root, name)
    assert list(out) == KEYS
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["metrics"] == {}  # a CPU run reports no device metric
    assert set(out["checks"]) == set(harness.find_cell(name, tiny_root).checks["numbers"])


def test_traced_rehearsal_has_breakdown(tiny_root):
    out = rehearse(tiny_root, CELLS[0], trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["attempted"] == 4  # trace_calls = 1 call of 4 lanes


def run_py(root, args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | (env_extra or {})
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


def test_command_last_line(tiny_root):
    proc = run_py(tiny_root, ["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1",
                              "--trace", "0", "--rehearse"], {"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"] is True
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_no_card_no_result(tiny_root):
    proc = run_py(tiny_root, ["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                              "--trace", "0"], {"PYTHONPATH": str(REPO)})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_py(tmp_path, ["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                             "--trace", "0", "--rehearse"])
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_new_config_mix_and_metric_as_files_only(tmp_path):
    """A throwaway configuration, mix and per-layer metric join as new
    files and new BENCHMARK.json entries; no existing file is edited."""
    root = make_tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "perfbench/configs/nonnegpca-n50.json").read_text())
    cfg.update(name="nonnegpca-n24", dim=24)
    (root / "perfbench/configs/nonnegpca-n24.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/riptrm-sweep-b131072.json").read_text())
    mix.update(lanes=3, max_steps=150)
    (root / "perfbench/traffic/riptrm-sweep-b3.json").write_text(json.dumps(mix))
    shutil.copy(root / "perfbench/checks/nonnegpca-n50.riptrm-sweep-b131072.json",
                root / "perfbench/checks/nonnegpca-n24.riptrm-sweep-b3.json")
    (root / "perfbench/metrics/solver.lanes_per_call.py").write_text(
        "def read(run):\n    return sum(len(c.steps) for c in run.calls) / len(run.calls)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "nonnegpca-n24", "source": "test",
                             "file": "perfbench/configs/nonnegpca-n24.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "nonnegpca-n24.riptrm-sweep-b3",
                               "config": "nonnegpca-n24", "traffic": "riptrm-sweep-b3",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "solver.lanes_per_call", "unit": "lanes",
                               "better": "higher", "source": "program_counter",
                               "layer": "solvers and sweeps", "moves": "solves_per_s",
                               "workloads": ["nonnegpca-n24.riptrm-sweep-b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())

    cell = harness.find_cell("nonnegpca-n24.riptrm-sweep-b3", root)
    assert [m["name"] for m in cell.per_layer] == ["solver.lanes_per_call"]
    out = rehearse(root, cell.name)
    assert out["correct"] and out["attempted"] % 3 == 0
    run = harness.Run(cell, SEED, torch.device("cpu"),
                      [harness.Call(0, 0.0, 1.0, None, None, [1, 2, 3], None)], 1.0, 0.0)
    assert cell.piece("metrics", "solver.lanes_per_call").read(run) == 3.0


# A throwaway family: NonnegPCA with each start packed as [1, n], solved
# on the port's Product of one sphere, so that the harness's reshape of
# the pool, its shape test and its unmoved-lane test see a point of more
# than one axis after the lane axis.
PACKED = {
    "gen/packed_pca.py": '''
from perfbench.gen import nonneg_pca


def instance(rng, cfg):
    return nonneg_pca.instance(rng, cfg)


def starts(rng, cfg, count):
    return nonneg_pca.starts(rng, cfg, count)[:, None, :]
''',
    "program/packed_pca.py": '''
import dataclasses

from perfbench.program import nonneg_pca


def make_problem(arrays, x0, cfg, device, matmul_precision):
    from riptrm_torch.manifolds import Product

    base = nonneg_pca.make_problem(arrays, x0[0], cfg, device, matmul_precision)
    return dataclasses.replace(
        base, manifold=Product([base.manifold]), x0=x0, structure=None,
        cost_fn=lambda x: base.cost_fn(x[0]), ineq_fn=lambda x: base.ineq_fn(x[0]),
        manvio_fn=lambda x: base.manvio_fn(x[0]))
''',
    "reference/packed_pca.py": '''
from perfbench.reference import nonneg_pca


def residual(arrays, cfg, x, y):
    return nonneg_pca.residual(arrays, cfg, x.flatten(1), y)
''',
}


@pytest.mark.parametrize("admitted", [True, False], ids=["in_benchmark", "held_back"])
def test_new_family_as_files_only(tmp_path, monkeypatch, admitted):
    """A configuration of a new family (its points [1, n] a lane), its
    mix, its checks and its gen, program and reference modules join as new
    files, either with new BENCHMARK.json entries or held back by its
    checks file alone; no existing file is edited.  Its cell rehearses
    correct at the configuration's own sizes (it has no ``rehearsal``
    key), and a step that returns its state makes it not correct."""
    from perfbench.tests.test_perfbench_faults import step_unchanged

    src = tmp_path / "src"
    shutil.copytree(REPO / "perfbench", src / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", src)
    before = {p: p.read_bytes() for p in src.rglob("*") if p.is_file()}
    for name, text in PACKED.items():
        (src / "perfbench" / name).write_text(text.lstrip())
    cfg = json.loads((src / "perfbench/configs/nonnegpca-n50.json").read_text())
    del cfg["rehearsal"]
    cfg.update(name="packedpca-n24", family="packed_pca", dim=24)
    (src / "perfbench/configs/packedpca-n24.json").write_text(json.dumps(cfg))
    mix = json.loads((src / "perfbench/traffic/riptrm-sweep-b131072.json").read_text())
    mix.update(fused_tcg=False, lanes=3)
    del mix["tcg_sample_lanes"], mix["starts_pool"]
    (src / "perfbench/traffic/riptrm-generic-b3.json").write_text(json.dumps(mix))
    name = "packedpca-n24.riptrm-generic-b3"
    checks = {"numbers": {"resid_gap": {"limit": 0.01}, "lane_resid_over_tol": {"limit": 1.0},
                          "unmoved_lanes": {"limit": 0}}}
    if admitted:
        bench = json.loads((src / "BENCHMARK.json").read_text())
        bench["configs"].append({"name": "packedpca-n24", "source": "test",
                                 "file": "perfbench/configs/packedpca-n24.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": name, "config": "packedpca-n24",
                                   "traffic": "riptrm-generic-b3", "chips": 1, "why": "test"})
        (src / "BENCHMARK.json").write_text(json.dumps(bench))
    else:
        checks.update(config="packedpca-n24", traffic="riptrm-generic-b3")
    (src / "perfbench/checks" / f"{name}.json").write_text(json.dumps(checks))
    assert all(p.read_bytes() == b for p, b in before.items()
               if not (admitted and p.name == "BENCHMARK.json"))
    assert [w["name"] for w in held_back(src)] == (
        [w["name"] for w in held_back()] + ([] if admitted else [name]))

    root = make_tiny_root(tmp_path / "tiny", src)
    cell = harness.find_cell(name, root)
    arrays, starts = harness.make_inputs(cell, SEED)
    assert starts.shape == (3, 3, 1, 24) and arrays["Z"].shape == (24, 24)
    out = rehearse(root, name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] % 3 == 0, out["checks"]
    step_unchanged(monkeypatch)
    out = rehearse(root, name, seconds=0.5)
    assert not out["correct"] and out["failed"] == out["attempted"], out["checks"]
    assert out["checks"]["unmoved_lanes"]["value"] == out["attempted"]

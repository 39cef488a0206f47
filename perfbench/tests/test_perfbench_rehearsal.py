"""Whole runs of every mix on the CPU at a tiny size (the configuration
cut to n = 40, at most 4 lanes a call), the command's last line, and a
configuration, mix and metric added as new files only."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import HELD_BACK, REPO

BENCH_CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
CELLS = BENCH_CELLS + [w["name"] for w in HELD_BACK]  # rehearsed in the tiny copy
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
    from perfbench.tests.conftest import make_tiny_root

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

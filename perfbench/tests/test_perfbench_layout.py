"""BENCHMARK.json against the benchmark's contract, and every piece a
cell names found by its name."""

import json
import re

from perfbench import harness
from perfbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert all((REPO / p).is_dir() for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["workloads"] and set(m["workloads"]) <= cells


def test_every_cell_finds_its_pieces(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        for module in (cell.gen, cell.program, cell.reference, cell.entry):
            assert module is not None
        names = {m["name"] for m in cell.metrics}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.metrics + cell.per_layer:
            assert hasattr(cell.piece("metrics", m["name"]), "read")
        assert set(cell.checks["numbers"]) <= {"resid_gap", "lane_resid_over_tol",
                                               "unmoved_lanes", "tcg_heta_gap"}


def test_each_config_used_and_file_under_paths(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert used == {c["name"] for c in bench["configs"]} and len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]


def test_pairs_appear_once(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)

"""CPU tests of the benchmark (``python -m pytest perfbench/tests``).

``tiny_root`` is a copy of the benchmark whose configurations are cut to
sizes a CPU run holds in seconds (each configuration's own ``rehearsal``
sizes, or its own sizes where it has none), whose mixes run at most 4
lanes, and which holds every held-back cell, for rehearsals of the whole
run on the CPU.  A held-back cell is a ``checks/<cell>.json`` that names
its ``config`` and ``traffic`` and whose cell ``BENCHMARK.json`` leaves
out until its runs hold still on the card (PERF.md, Open questions)."""

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def held_back(root: pathlib.Path = REPO) -> list:
    """The held-back cells of ``root``'s benchmark, as workload entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]}
    cells = []
    for path in sorted((root / "perfbench" / "checks").glob("*.json")):
        checks = json.loads(path.read_text())
        if path.stem not in names and "config" in checks and "traffic" in checks:
            cells.append({"name": path.stem, "config": checks["config"],
                          "traffic": checks["traffic"], "chips": 1, "why": "held back"})
    return cells


@pytest.fixture(autouse=True)
def one_thread():
    # the CPU's batched LU (RIPM's dense solve) hangs in MKL with more
    # than one thread at B >= 2 on some hosts
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_tiny_root(dest: pathlib.Path, src: pathlib.Path = REPO) -> pathlib.Path:
    """A tiny copy of ``src``'s benchmark at ``dest``, with its held-back
    cells in its BENCHMARK.json (a held-back cell's configuration too,
    from ``configs/<config>.json``, where no entry names it)."""
    shutil.copytree(src / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    configs = {c["name"] for c in bench["configs"]}
    for cell in held_back(src):
        bench["workloads"].append(cell)
        if cell["config"] not in configs:
            configs.add(cell["config"])
            bench["configs"].append({"name": cell["config"], "source": "held back",
                                     "file": f"perfbench/configs/{cell['config']}.json",
                                     "reduced": [], "why": "held back"})
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(cfg.get("rehearsal", {}))
        path.write_text(json.dumps(cfg))
    for path in (dest / "perfbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(lanes=min(mix["lanes"], 4), pool_sweeps=3, max_steps=200, trace_calls=1)
        path.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())

"""CPU tests of the benchmark (``python -m pytest perfbench/tests``).

``tiny_root`` is a copy of the benchmark whose configurations are cut to
sizes a CPU run holds in seconds (n = 40) and whose mixes run at most 4
lanes, for rehearsals of the whole run on the CPU."""

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"nonneg_pca": {"dim": 40}}
# Cells whose files are in perfbench/ but that BENCHMARK.json leaves out
# until their runs hold still on the card (PERF.md, Open questions): the
# tiny copy adds them, so that the CPU rehearsals keep their pieces (K3's
# probe, the tCG reference, the control's stand-in) working.
HELD_BACK = [{"name": "nonnegpca-n50.riptrm-sweep-b131072", "config": "nonnegpca-n50",
              "traffic": "riptrm-sweep-b131072", "chips": 1, "why": "held back"}]


@pytest.fixture(autouse=True)
def one_thread():
    # the CPU's batched LU (RIPM's dense solve) hangs in MKL with more
    # than one thread at B >= 2 on some hosts
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_tiny_root(dest: pathlib.Path) -> pathlib.Path:
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] += HELD_BACK
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["family"]])
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

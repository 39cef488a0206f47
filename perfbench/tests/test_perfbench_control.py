"""The lower-precision control comes out not correct, on the card (marked
``cuda``; skipped without one): each cell run with the program's TF32
path switched on and, where the cell compares the tCG step, the kernel
replaced by the reference's tCG in TF32 (``--control``), for a short
window at the cell's own size.

    python -m pytest perfbench/tests/test_perfbench_control.py -m cuda
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_rehearsal import BENCH_CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", BENCH_CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the program on the card")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name,
                           "--seed", str(2**31 + 5), "--seconds", "5", "--trace", "0",
                           "--control"], cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]

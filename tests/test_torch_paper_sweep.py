"""``python -m riptrm_torch.experiment.paper_sweep`` on the CPU.

The port's 10-instance sweep reads the tracked ``dataset/NonnegPCA/<i>``
instances and refuses a missing one by name (it does not generate the
reference's instances).  Its CPU configuration (float64, tolresid 1e-15,
the JAX module's) runs here on copies of two tracked instances in a
temporary dataset root, 480 steps (both lanes settle near 7e-15 by step
~460); every residual must reach 1e-12 (the JAX package's
``result/NonnegPCA_instance_sweep.json`` records at most 8.3e-15 after 2000
steps), and the report carries the JAX report's keys.
"""

import json
import os
import shutil

import pytest
import torch

from riptrm_torch.experiment import paper_sweep

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REPORT = os.path.join(REPO, "result", "NonnegPCA_instance_sweep.json")


def _copy(root, instances):
    for i in instances:
        shutil.copytree(os.path.join(REPO, "dataset", "NonnegPCA", str(i)), root / str(i))


def test_refuses_a_missing_instance(tmp_path):
    _copy(tmp_path, (1,))
    with pytest.raises(FileNotFoundError, match="instance 2 is missing"):
        paper_sweep.main(["--device", "cpu", "--dataset", str(tmp_path), "--instances", "2",
                          "--out", str(tmp_path / "out.json"), "--plot", ""])
    assert not (tmp_path / "out.json").exists()


def test_cpu_configuration_on_two_instances(tmp_path, capsys):
    _copy(tmp_path, (1, 2))
    out_path = tmp_path / "sweep.json"
    plot_path = tmp_path / "torch" / "box.png"
    out = paper_sweep.main(["--device", "cpu", "--dataset", str(tmp_path), "--instances", "2",
                            "--max-steps", "480", "--out", str(out_path),
                            "--plot", str(plot_path)])
    with open(out_path) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    with open(JAX_REPORT) as f:
        assert set(out) == set(json.load(f))
    assert sorted(out["jobs"]) == ["1/a", "2/a"] and out["dtype"] == "float64"
    for job in out["jobs"].values():
        assert job["residual"] <= 1e-12 and job["steps"] == 480
    assert out["max_residual"] <= 1e-12 and out["device"] == "cpu"
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["jobs"] == 2 and line["plot"] in (str(plot_path), None)

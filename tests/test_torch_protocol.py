"""The port's paper-protocol speedrun against ``riptrm_tpu``'s, on the CPU.

``protocol_speedrun --problems NonnegPCA --slack 1.05 --device cpu``: the
targets are the JAX package's round-5 targets
(``result/protocol_speedrun_r5.json``, the best residuals of
``result/benchmark_summary.json`` times 1.05), and RSQO, RIPTRM and RIPM
reach theirs.  RALM's group misses its target (ROADMAP queue 3): the
reference reaches 3.957e-4 only in its unbatched jitted program, its own
batched sweep stops at 4.777e-4 (r5 counted the group through its rescue
pass), and the port's RALM, which follows the JAX package's eager steps,
plateaus at 4.2275e-4 above the target 4.155e-4.  Its test holds the port
to the reference's batched sweep on the same group instead.  Also:
``stack_points`` against the JAX function, the rescue pass on a two-lane
group, and the report file.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.experiment import protocol_speedrun as tps
from riptrm_tpu.experiment import protocol_speedrun as jps

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "result", "protocol_speedrun_r5.json")) as f:
    R5 = json.load(f)["groups"]


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    monkeypatch.chdir(REPO)


def test_nonneg_pca_reaches_r5_targets(tmp_path):
    out = str(tmp_path / "ps.json")
    report = tps.main(["--problems", "NonnegPCA", "--solvers", "RSQO,RIPTRM,RIPM",
                       "--slack", "1.05", "--max-steps", "400", "--out", out,
                       "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    groups = report["groups"]
    assert sorted(groups) == sorted(k for k in R5 if k.startswith("NonnegPCA/")
                                    and "RALM" not in k)
    for key, g in groups.items():
        np.testing.assert_allclose(g["targets"], R5[key]["targets"], rtol=1e-12)
        assert g["reached"] == [True], (key, g["best"], g["targets"])
        assert g["run_s"] > 0 and g["warmup_s"] > 0 and g["rescued"] == [False]
    # the post-hoc certificate at RIPTRM's final point (least Ritz value of Hw)
    assert groups["NonnegPCA/1/RIPTRM_tCG"]["second_order_mineig"][0] > 0
    assert report["total"]["jobs"] == report["total"]["reached"] == 3
    assert report["total"]["device"] == "cpu"


def test_ralm_group_against_the_reference_batched_sweep(tmp_path):
    """The recorded miss: the port's batched RALM group ends at or below the
    JAX package's own batched sweep on the same group (both above r5's
    target, which only the reference's unbatched program reaches)."""
    from riptrm_tpu.experiment.cfg import solver_options_from_cfg, sweep_configs
    from riptrm_tpu.parallel.sweep import batched_protocol_sweep

    steps = 60
    report = tps.main(["--problems", "NonnegPCA", "--solvers", "RALM", "--slack", "1.05",
                       "--max-steps", str(steps), "--out", str(tmp_path / "ps.json"),
                       "--device", "cpu"])
    g = report["groups"]["NonnegPCA/1/RALM_SteepestDescent"]
    np.testing.assert_allclose(g["targets"], R5["NonnegPCA/1/RALM_SteepestDescent"]["targets"],
                               rtol=1e-12)
    cfgs = sweep_configs("configs/NonnegPCA/config_simulation.yaml")
    problem, xs0, ys0, _ = jps.stack_points(cfgs)
    option = solver_options_from_cfg(cfgs[0], "RALM")
    option.pop("maxtime")
    _, _, _, jbest = batched_protocol_sweep(problem, "RALM", option, steps)(
        xs0, ys0, jnp.asarray(g["targets"]))
    assert g["best"][0] <= float(jbest[0])
    assert g["best"][0] < 1.1 * g["targets"][0]


def test_stack_points_matches_jax():
    from riptrm_tpu.experiment.cfg import sweep_configs

    cfgs = sweep_configs("configs/StableIdentification/config_simulation.yaml")[:4]
    jp, jxs, jys, jpts = jps.stack_points(cfgs)
    tp, txs, tys, tpts = tps.stack_points(cfgs, device="cpu")
    assert tpts == jpts == ["a", "b", "c", "d"]
    for t, j in zip(tp.manifold.unpack(txs), jxs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tys.numpy(), np.asarray(jys))


def test_rescue_reruns_missed_lanes_alone():
    from riptrm_torch.experiment.cfg import solver_options_from_cfg, sweep_configs

    cfgs = sweep_configs("configs/NonnegPCA/config_simulation.yaml")
    problem, xs0, ys0, _ = tps.stack_points(cfgs * 2, device="cpu")
    option = solver_options_from_cfg(cfgs[0], "RSQO")
    option.pop("maxtime")
    best, ks = [1.0, 1e-20], [3, 3]
    rescued, run_s = tps.rescue_missed_lanes(problem, "RSQO", option, 3, xs0, ys0,
                                             [1e-30, 1e-30], best, ks)
    assert rescued == [True, True] and run_s > 0
    assert best[0] < 1.0 and best[1] == 1e-20  # each lane keeps its better result
    # a one-lane group is its own one-lane program: no re-run
    assert tps.rescue_missed_lanes(problem, "RSQO", option, 3, xs0[:1], ys0[:1], [1e-30],
                                   [1.0], [3]) == ([False], 0.0)

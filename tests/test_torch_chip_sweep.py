"""The port's GPU sweep CLI (``experiment/chip_sweep.py``) on the CPU.

(a) ``build_sweep`` from the JAX package's committed payloads: the same
    instance and starts as the JAX ``build_sweep`` at NonnegPCA n = 1000 and
    BoundedPCA St(128, 8), B = 16 (identical float32 arrays), and a batch
    served by slicing a larger committed payload;
(b) the port's own payloads (other random streams): the JAX tests'
    feasibility checks for every family, and the cache round trip under a
    ``torch_`` name, never the JAX key;
(c) ``measure_sweep`` at n = 32 (RIPTRM, and RSQO with the Newton-Schulz
    QP) and the CLI's JSON line; the compacted staged solve's flags.
"""

import json
import os

import numpy as np
import pytest
import torch

from riptrm_torch.experiment import chip_sweep as tcs
from riptrm_tpu.experiment import chip_sweep as jcs

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


@pytest.mark.parametrize("problem,size", [("NonnegPCA", 1000), ("BoundedPCA", 128)])
def test_build_sweep_matches_jax_from_committed_cache(problem, size, monkeypatch):
    monkeypatch.setenv("RIPTRM_CACHE_DIR", os.path.join(REPO, "dataset", "_cache"))
    payload = jcs._cache_load(problem, size, 16, 0)  # the JAX package reads its own cache
    assert payload is not None
    jp, jxs, jys = jcs._build_from_payload(problem, size, 16, payload)
    tp, txs, tys = tcs.build_sweep(problem, size, 16, **CPU)
    assert txs.dtype == torch.float32
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(tys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(tp.structure["Zs"].numpy(), np.asarray(jp.structure["Zs"]))
    np.testing.assert_array_equal(tp.x0.numpy(), np.asarray(jp.x0))
    assert tcs._cache_load(problem, size, 16, 0)[1] == "jax"


def test_committed_payload_is_sliced():
    """B = 4 from the committed B = 16 NonnegPCA payload: its first lanes."""
    _, xs16, _ = tcs.build_sweep("NonnegPCA", 1000, 16, **CPU)
    _, xs4, _ = tcs.build_sweep("NonnegPCA", 1000, 4, **CPU)
    np.testing.assert_array_equal(xs4.numpy(), xs16[:4].numpy())


def test_build_sweep_stable_identification(tmp_path, monkeypatch):
    monkeypatch.setenv("RIPTRM_CACHE_DIR", str(tmp_path))
    problem, xs0, ys0 = tcs.build_sweep("StableIdentification", 3, 2, seed=1, **CPU)
    assert xs0.shape == (2, 3, 3, 3)  # (J, R, Q) packed per lane
    assert ys0.shape == (2, problem.num_ineq)
    assert bool(torch.all(problem.ineq_val(xs0) < 0))  # strictly feasible starts
    assert bool(torch.all(torch.isfinite(problem.manvio(xs0))))


def test_build_sweep_rosenbrock(tmp_path, monkeypatch):
    monkeypatch.setenv("RIPTRM_CACHE_DIR", str(tmp_path))
    problem, xs0, ys0 = tcs.build_sweep("Rosenbrock", 5, 3, seed=2, **CPU)
    assert xs0.shape == (3, 5, 3) and ys0.shape == (3, problem.num_ineq)
    eye = torch.eye(3).expand(3, 3, 3)
    torch.testing.assert_close(xs0.mT @ xs0, eye, atol=1e-5, rtol=0)
    assert bool(torch.all(problem.ineq_val(xs0) < 0))


def test_build_sweep_bounded_pca(tmp_path, monkeypatch):
    monkeypatch.setenv("RIPTRM_CACHE_DIR", str(tmp_path))
    problem, xs0, _ = tcs.build_sweep("BoundedPCA", 32, 2, seed=3, **CPU)
    assert xs0.shape == (2, 32, 2)
    torch.testing.assert_close(xs0.mT @ xs0, torch.eye(2).expand(2, 2, 2), atol=1e-5, rtol=0)
    assert bool(torch.all(problem.ineq_val(xs0) < 0))


def test_build_sweep_low_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("RIPTRM_CACHE_DIR", str(tmp_path))
    problem, xs0, _ = tcs.build_sweep("LowRank", 16, 2, seed=4, **CPU)
    u, s, v = problem.manifold.unpack(xs0)
    assert u.shape == (2, 16, 2) and s.shape == (2, 2) and v.shape == (2, 8, 2)
    assert bool(torch.all(problem.slack(xs0) > 0))


def test_build_sweep_cache_roundtrip(tmp_path, monkeypatch):
    """A payload the port generates is stored under a ``torch_`` name (never
    the JAX key), a second build reproduces the sweep, a smaller batch is
    served by slicing it, and cache=False neither reads nor writes."""
    monkeypatch.setenv("RIPTRM_CACHE_DIR", str(tmp_path))
    p1, xs1, _ = tcs.build_sweep("StableIdentification", 3, 3, seed=7, **CPU)
    assert [f.name for f in tmp_path.iterdir()] == ["torch_StableIdentification_s3_seed7_b3.npz"]
    payload, source = tcs._cache_load("StableIdentification", 3, 3, 7)
    assert source == "torch" and payload["b_J"].shape == (3, 3, 3)
    p2, xs2, _ = tcs.build_sweep("StableIdentification", 3, 3, seed=7, **CPU)
    assert torch.equal(xs1, xs2)
    assert torch.equal(p1.ineq_val(xs1), p2.ineq_val(xs2))
    _, xs3, _ = tcs.build_sweep("StableIdentification", 3, 2, seed=7, **CPU)
    assert torch.equal(xs3, xs1[:2])
    tcs.build_sweep("NonnegPCA", 8, 2, seed=7, cache=False, **CPU)
    assert tcs._cache_load("NonnegPCA", 8, 2, 7) == (None, None)


OPTION = {
    "maxiter": 60,
    "tolresid": 1e-3,
    "TRS_solver": "tCG",
    "second_order_stationarity": False,
    "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
    "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-4),
}


def test_measure_sweep_nonneg_pca():
    """The JAX test's case (n = 32 from the committed payload, B = 2)."""
    problem, xs0, ys0 = tcs.build_sweep("NonnegPCA", 32, 2, **CPU)
    per_sweep, res, warmup_s, steps, (x, y), launches = tcs.measure_sweep(
        problem, xs0, ys0, OPTION, max_steps=150, reps=2)
    assert per_sweep > 0 and warmup_s > 0
    assert res.shape == (2,) and np.all(res < 1e-2)
    assert x.shape == (2, 32) and y.shape == (2, 32) and np.all(steps <= 150)
    assert not any(launches.values())  # CPU tensors: the kernels' plain versions


def test_measure_sweep_rsqo_schulz():
    problem, xs0, ys0 = tcs.build_sweep("NonnegPCA", 32, 2, **CPU)
    option = {"maxiter": 40, "tolresid": 1e-3, "quadoptim_type": "reghess_shift",
              "quadoptim_linear_solver": "schulz"}
    per_sweep, res, *_ = tcs.measure_sweep(problem, xs0, ys0, option, max_steps=60, reps=1,
                                           solver="RSQO")
    assert per_sweep > 0 and np.all(res < 1e-2)


def test_cli_json_line(capsys):
    out = tcs.main(["--problem", "NonnegPCA", "--size", "32", "--batch", "4", "--reps", "1",
                    "--fused", "--certify", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["cache"] == "jax" and line["device"] == "cpu" and line["fused"] is True
    assert len(line["residuals"]) == 4 and line["median_residual"] < 1e-3
    assert line["launches"] == {} and line["certified_lanes"] == 4
    for key in ("solves_per_sec", "sweep_ms", "mean_steps", "warmup_s", "gen_s"):
        assert line[key] > 0


@pytest.mark.parametrize("flag", [["--staged-compact"], ["--staged-segment-steps", "50"],
                                  ["--staged-precision", "--staged-compact"],
                                  ["--staged-precision", "--staged-segment-steps", "50"]])
def test_jax_only_flags_are_refused(flag, capsys):
    """The compacted staged solve's flags, as the JAX CLI treats them: with
    --staged-precision, --staged-compact runs the compacted solve
    (staged_precision_riptrm_compacted) and --staged-segment-steps sets
    its segments; without --staged-compact the flag changes nothing, and
    neither does --staged-compact without --staged-precision."""
    out = tcs.main(["--size", "32", "--batch", "2", "--reps", "1", "--max-steps", "120",
                    "--device", "cpu"] + flag)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    staged = "--staged-precision" in flag
    compact = staged and "--staged-compact" in flag
    assert out["mode"] == ("staged_precision_compacted" if compact
                           else "staged_precision" if staged else "tCG")
    assert len(out["residuals"]) == 2 and np.all(np.isfinite(out["residuals"]))
    if compact:
        assert out["segment_steps"] == 100 and out["point"] == "best"
        assert len(out["segments_used"]) == 2 and min(out["segments_used"]) >= 1
        assert out["median_residual"] <= out["phase1_median_residual"] * (1 + 1e-5)
        assert out["floor_improvement_x"] >= 1.0
    else:
        assert "segments_used" not in out

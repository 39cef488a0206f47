"""Checkpoint / resume of the port against ``riptrm_tpu``, float64 on the CPU.

The JAX ``tests/test_checkpoint.py`` cases on the port (a state round
trip, RIPTRM's resume continuing the run, the job-done marker, legacy
positional checkpoints with their shape check, a layout mismatch refused,
the metadata inside the archive), plus the cross-package case: a one-lane
checkpoint written by the JAX package's ``RIPTRM.run`` is resumed by the
port's and reaches the JAX resume's final cost to 1e-8, with the JAX
resume's residuals at every outer iteration to rtol 1e-6 (the residuals
stay above 8e-4 in these 10 iterations, where the reference does not move
under rounding, ROADMAP queue 3).
"""

import json
import os

import numpy as np
import pytest
import torch

from riptrm_torch.experiment.checkpoint import job_is_done, load_state, save_state
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.experiment import checkpoint as jck
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers import riptrm as jrm

torch.set_num_threads(1)
DATA = "dataset/NonnegPCA/1"
TCG = {"TRS_solver": "tCG", "second_order_stationarity": False}


@pytest.fixture(scope="module")
def pca():
    return tn.load_problem(DATA, "a", device="cpu")


def test_state_roundtrip(tmp_path, pca):
    st = trm.init_state(pca, trm.RIPTRM(TCG).option)
    path = str(tmp_path / "ck.npz")
    save_state(path, st, {"elapsed": 1.5})
    st2, meta = load_state(path, st)
    assert meta["elapsed"] == 1.5
    for f in ("x", "y", "mu", "outer_iter", "cache_valid", "h_q"):
        a, b = getattr(st, f), getattr(st2, f)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f
    with np.load(path) as data:  # the JAX package's key names
        assert {"leaf.x", "leaf.h_lam", "leaf.outer_iter", "__meta__"} <= set(data.files)


def test_riptrm_resume_continues(tmp_path, pca):
    """Interrupt a solve after a few outer iterations; a resumed run must
    continue (not restart), reach a better residual and log exactly what
    the uninterrupted run logs."""
    path = str(tmp_path / "run.npz")
    base = TCG | {"maxtime": 120, "tolresid": 1e-9, "checkpoint_path": path,
                  "checkpoint_every": 0.0}
    out1 = trm.RIPTRM(base | {"maxiter": 4}).run(pca)
    res1 = out1.log["residual"][-1]
    assert max(out1.log["iteration"]) >= 4

    out2 = trm.RIPTRM(base | {"maxiter": 10, "resume": True}).run(pca)
    assert max(out2.log["iteration"]) >= 10
    assert out2.log["residual"][-1] < res1
    n = len(out1.log["residual"])
    np.testing.assert_allclose(out2.log["residual"][:n], out1.log["residual"], rtol=1e-12)
    whole = trm.RIPTRM(base | {"maxiter": 10, "checkpoint_path": None}).run(pca)
    assert out2.log["residual"] == whole.log["residual"]
    assert out2.log["iteration"] == whole.log["iteration"]


def test_job_done_marker(tmp_path):
    assert not job_is_done(str(tmp_path), "X")
    (tmp_path / "X_log.csv").write_text("iteration\n0\n")
    assert job_is_done(str(tmp_path), "X")


def test_load_legacy_positional_checkpoint(tmp_path):
    """Checkpoints of the pre-name-keying format (leaf_<i> keys, meta in the
    sidecar only) still load."""
    tmpl = {"a": np.zeros(3), "b": np.zeros((2, 2))}
    path = str(tmp_path / "old.npz")
    np.savez(path, leaf_0=np.arange(3.0), leaf_1=np.eye(2))
    with open(path + ".meta.json", "w") as f:
        json.dump({"k": 7}, f)
    state, meta = load_state(path, tmpl)
    np.testing.assert_array_equal(state["a"], np.arange(3.0))
    np.testing.assert_array_equal(state["b"], np.eye(2))
    assert meta == {"k": 7}


def test_load_state_rejects_layout_mismatch(tmp_path, pca):
    path = str(tmp_path / "s.npz")
    save_state(path, {"a": np.zeros(3)}, {"k": 1})
    with pytest.raises(ValueError, match="lacks field"):
        load_state(path, {"other": np.zeros(3)})
    with pytest.raises(ValueError, match="lacks field"):
        load_state(path, trm.init_state(pca, trm.RIPTRM(TCG).option))
    # a state of another problem size: same fields, other shapes
    small = tn.make_problem(np.eye(4), np.full(4, 0.5), device="cpu")
    save_state(path, trm.init_state(small, trm.RIPTRM(TCG).option))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, trm.init_state(pca, trm.RIPTRM(TCG).option))


def test_meta_embedded_in_archive(tmp_path):
    """State + meta are one atomic file: meta round-trips even if the
    sidecar .meta.json is deleted (or was torn by a kill)."""
    path = str(tmp_path / "s.npz")
    save_state(path, {"a": np.arange(4.0)}, {"steps_done": 40})
    os.remove(path + ".meta.json")
    state, meta = load_state(path, {"a": np.zeros(4)})
    assert meta == {"steps_done": 40}
    np.testing.assert_array_equal(state["a"], np.arange(4.0))


def test_legacy_positional_requires_matching_shapes(tmp_path):
    path = str(tmp_path / "legacy.npz")
    np.savez(path, leaf_0=np.zeros((3, 3)), leaf_1=np.zeros(5),
             __meta__=np.asarray(json.dumps({})))
    state, _ = load_state(path, {"a": np.zeros((3, 3)), "b": np.zeros(5)})
    assert state["a"].shape == (3, 3)
    with pytest.raises(ValueError, match="different solver-state layout"):
        load_state(path, {"a": np.zeros((4, 4)), "b": np.zeros(5)})


def test_dict_checkpoints_cross_packages(tmp_path):
    """A dict state saved by either package loads in the other."""
    a = {"a": np.arange(3.0), "b": np.eye(2)}
    jck.save_state(str(tmp_path / "j.npz"), a, {"k": 1})
    save_state(str(tmp_path / "t.npz"), a, {"k": 2})
    st, meta = load_state(str(tmp_path / "j.npz"), {"a": np.zeros(3), "b": np.zeros((2, 2))})
    np.testing.assert_array_equal(st["b"], np.eye(2))
    assert meta == {"k": 1}
    st, meta = jck.load_state(str(tmp_path / "t.npz"), {"a": np.zeros(3), "b": np.zeros((2, 2))})
    np.testing.assert_array_equal(st["a"], np.arange(3.0))
    assert meta == {"k": 2}


def test_jax_checkpoint_resumes_in_the_port(tmp_path, pca):
    """A JAX ``RIPTRM.run`` checkpoint (one lane, no lane axis) loads through
    ``state_from_numpy`` and the port's resumed run reaches the JAX resume's
    final cost."""
    jp = jn.load_problem(DATA, "a")
    path = str(tmp_path / "jax.npz")
    base = TCG | {"maxtime": 120, "tolresid": 1e-9, "checkpoint_path": path,
                  "checkpoint_every": 0.0}
    jrm.RIPTRM(base | {"maxiter": 4}).run(jp)
    jstate, jmeta = jck.load_state(path, jrm.init_state(jp, jrm.RIPTRM(base).option))

    template = trm.init_state(pca, trm.RIPTRM(base).option)
    tstate, tmeta = load_state(path, template)
    want = trm.state_from_numpy(jstate._asdict(), device="cpu")
    for f in ("x", "y", "mu", "tr_radius", "outer_iter", "inner_count", "cache_valid"):
        a, b = getattr(tstate, f), getattr(want, f)
        assert a.shape == getattr(template, f).shape and torch.equal(a, b), f
    assert tmeta == jmeta

    with open(path, "rb") as f:
        ckpt = f.read()
    jout = jrm.RIPTRM(base | {"maxiter": 10, "resume": True}).run(jp)
    with open(path, "wb") as f:  # the JAX resume moved the checkpoint on
        f.write(ckpt)
    tout = trm.RIPTRM(base | {"maxiter": 10, "resume": True}).run(pca)
    assert tout.log["cost"][-1] == pytest.approx(jout.log["cost"][-1], abs=1e-8)
    assert max(tout.log["iteration"]) == max(jout.log["iteration"])
    j, t = np.array(jout.log["residual"]), np.array(tout.log["residual"])
    n = len(jmeta["log"]["residual"])
    np.testing.assert_array_equal(t[:n], j[:n])  # the restored log itself
    # the outer iterations' rows (inner rows amplify rounding: a tCG walk
    # mid-iteration moves by up to 2e-4 between the packages, resumed or not)
    assert tout.log["inner_status"] == jout.log["inner_status"]
    outer = np.array([s in (None, "converged") for s in jout.log["inner_status"]])
    np.testing.assert_allclose(t[outer], j[outer], rtol=1e-6)

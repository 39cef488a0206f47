"""Deployable sweep artifacts (``riptrm_torch/experiment/export_artifact.py``)
against the JAX package's (``riptrm_tpu/experiment/export_artifact.py``).

The four cases of ``tests/test_export_artifact.py`` at its sizes (N = 16,
B = 4; StableIdentification d = 3, B = 2), the inputs drawn from a numpy
seed and given to both packages: each package's artifact is exported,
reloaded and run, and the port's artifact is held to the port's direct
sweep and to the JAX artifact at the JAX test's tolerances.  Then the
``riptrm::`` tCG operator in an exported graph, the other solvers, a reload
in a fresh process, and the loop helper traced against eager
(``utils/lanes.py::lane_loop``: bit for bit).
"""

import collections
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.experiment import export_artifact as tea
from riptrm_torch.parallel.sweep import batched_solver_sweep
from riptrm_torch.problems import nonneg_pca as tnp
from riptrm_tpu.experiment import export_artifact as jea
from riptrm_tpu.problems import nonneg_pca as jnp_pca

torch.set_num_threads(1)
N, B = 16, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCG = {"TRS_solver": "tCG", "second_order_stationarity": False}


def _inputs(seed=0):
    """A NonnegPCA instance and B starts on the positive orthant of the
    sphere (numpy), and ones for the multipliers."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N))
    z = a @ a.T / N
    xs = np.abs(rng.standard_normal((B, N)))
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    return z, xs, np.ones((B, N))


def _both(seed=0):
    z, xs, ys = _inputs(seed)
    tp = tnp.make_problem(torch.tensor(z), torch.tensor(xs[0]), dtype=torch.float64,
                          device="cpu")
    jp = jnp_pca.make_problem(jnp.asarray(z), jnp.asarray(xs[0]))
    return (tp, torch.tensor(xs), torch.tensor(ys)), (jp, jnp.asarray(xs), jnp.asarray(ys))


def _port_artifact(tmp_path, problem, solver, option, batch, max_steps, name="sweep.pt2"):
    path = str(tmp_path / name)
    tea.export_sweep(problem, solver, option, path, batch=batch, max_steps=max_steps,
                     device="cpu")
    return tea.load_sweep(path)


def _jax_artifact(tmp_path, problem, solver, option, batch, max_steps):
    path = str(tmp_path / "jax.stablehlo")
    jea.export_sweep(problem, solver, option, path, batch=batch, max_steps=max_steps)
    run, _ = jea.load_sweep(path)
    return run


def _np(out):
    return [np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a) for a in out]


def test_export_roundtrip_matches_direct(tmp_path):
    (tp, txs, tys), (jp, jxs, jys) = _both()
    option = {"maxiter": 20, "tolresid": 1e-6, **TCG}
    run, manifest = _port_artifact(tmp_path, tp, "RIPTRM", option, B, 200)
    assert manifest["solver"] == "RIPTRM" and manifest["batch"] == B
    assert manifest["device"] == "cpu" and manifest["torch_version"] == torch.__version__
    assert manifest["kernel_library"].startswith("kernels_")
    x_a, y_a, ks_a, res_a = _np(run(txs, tys))
    x_d, y_d, ks_d, res_d = _np(batched_solver_sweep(tp, "RIPTRM", option, 200)(txs, tys))
    x_j, _, _, res_j = _np(_jax_artifact(tmp_path, jp, "RIPTRM", option, B, 200)(jxs, jys))
    # the traced program runs the direct sweep's operators in its order
    for a, d in zip((x_a, y_a, ks_a, res_a), (x_d, y_d, ks_d, res_d)):
        np.testing.assert_array_equal(a, d)
    # against the JAX artifact, the solutions at the JAX test's tolerance;
    # the two packages' float64 walks part by ~1 % in the last residual
    # digits below 1e-6, so both are held to the stop tolerance instead
    np.testing.assert_allclose(x_a, x_j, atol=1e-6)
    assert np.all(res_a <= 1e-6) and np.all(res_j <= 1e-6)


def test_export_baseline_solver(tmp_path):
    (tp, txs, tys), (jp, jxs, jys) = _both()
    option = {"maxiter": 100, "tolresid": 1e-6}
    run, _ = _port_artifact(tmp_path, tp, "RIPM", option, B, 100)
    x_a, _, ks_a, res_a = _np(run(txs, tys))
    assert np.all(res_a < 1e-5)
    x_d, _, ks_d, res_d = _np(batched_solver_sweep(tp, "RIPM", option, 100)(txs, tys))
    np.testing.assert_array_equal(x_a, x_d)  # no tracing inside a nested loop: exact
    np.testing.assert_array_equal(ks_a, ks_d)
    x_j, _, _, res_j = _np(_jax_artifact(tmp_path, jp, "RIPM", option, B, 100)(jxs, jys))
    assert np.all(res_j < 1e-5)
    np.testing.assert_allclose(x_a, x_j, atol=1e-6)


def test_export_pytree_points(tmp_path):
    """StableIdentification's (J, R, Q) points: one packed [B, 3, d, d]
    tensor a lane in the port (three leaves in the JAX manifest)."""
    from riptrm_torch.experiment import chip_sweep as tcs
    from riptrm_tpu.experiment import chip_sweep as jcs

    payload = tcs._generate_payload("StableIdentification", 3, 2, 0)
    tp, txs, tys = tcs._build_from_payload("StableIdentification", 3, 2, payload,
                                           dtype=torch.float32, device="cpu")
    jp, jxs, jys = jcs._build_from_payload("StableIdentification", 3, 2, payload)
    option = {"maxiter": 10, "tolresid": 1e-4, **TCG}
    run, manifest = _port_artifact(tmp_path, tp, "RIPTRM", option, 2, 60)
    assert manifest["x_shapes"] == [[2, 3, 3, 3]] and manifest["x_dtypes"] == ["float32"]
    x, y, ks, res = _np(run(txs, tys))
    assert np.all(np.isfinite(res))
    for a, d in zip((x, y, ks, res), _np(batched_solver_sweep(tp, "RIPTRM", option, 60)(txs, tys))):
        np.testing.assert_array_equal(a, d)
    _, _, _, res_j = _np(_jax_artifact(tmp_path, jp, "RIPTRM", option, 2, 60)(jxs, jys))
    assert np.all(np.isfinite(res_j))
    # float32 walks of 60 steps: the same residual class, not the same digits
    assert np.all(np.abs(np.log10(res) - np.log10(res_j)) < 1.0)


def test_manifest_validation(tmp_path):
    """A wrong batch size or dtype fails with the manifest's message."""
    (tp, txs, tys), _ = _both()
    run, _ = _port_artifact(tmp_path, tp, "RIPTRM",
                            {"maxiter": 5, "tolresid": 1e-3, **TCG}, B, 20)
    with pytest.raises(ValueError, match="shapes"):
        run(txs[:2], tys[:2])  # wrong batch
    with pytest.raises(ValueError, match="dtypes"):
        run(txs.float(), tys.float())


def _ops_in(program):
    ops = collections.Counter()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            ops.update(str(n.target) for n in module.graph.nodes if n.op == "call_function")
    return ops


def test_exported_graph_holds_tcg_operator(tmp_path):
    """With use_fused_tcg the NonnegPCA program calls riptrm::sphere_tcg
    inside its step loop, and (on the CPU, its plain version) gives the
    direct sweep's results bit for bit."""
    (tp, txs, tys), _ = _both(1)
    option = {"maxiter": 20, "tolresid": 1e-6, "use_fused_tcg": True, **TCG}
    run, _ = _port_artifact(tmp_path, tp, "RIPTRM", option, B, 200)
    ops = _ops_in(torch.export.load(str(tmp_path / "sweep.pt2")))
    assert ops["riptrm.sphere_tcg.default"] == 1 and ops["while_loop"] >= 1
    out = _np(run(txs, tys))
    direct = _np(batched_solver_sweep(tp, "RIPTRM", option, 200)(txs, tys))
    for a, d in zip(out, direct):
        np.testing.assert_array_equal(a, d)


def test_exported_ripm_holds_dense_solve_operator(tmp_path):
    """A float32 RIPM program calls riptrm::dense_solve for its Newton solve
    (the fake implementation gives its shape under torch.export), where a
    float64 one calls the library's solve, and (on the CPU, its plain
    version) gives the direct sweep's results bit for bit."""
    z, xs, ys = _inputs(2)
    tp = tnp.make_problem(torch.tensor(z), torch.tensor(xs[0]), dtype=torch.float32,
                          device="cpu")
    option = {"maxiter": 20, "tolresid": 1e-4}
    run, _ = _port_artifact(tmp_path, tp, "RIPM", option, B, 20)
    ops = _ops_in(torch.export.load(str(tmp_path / "sweep.pt2")))
    assert ops["riptrm.dense_solve.default"] == 1
    assert not any("linalg" in op and "solve" in op for op in ops)
    txs, tys = torch.tensor(xs, dtype=torch.float32), torch.tensor(ys, dtype=torch.float32)
    out = _np(run(txs, tys))
    direct = _np(batched_solver_sweep(tp, "RIPM", option, 20)(txs, tys))
    for a, d in zip(out, direct):
        np.testing.assert_array_equal(a, d)
    assert np.all(np.isfinite(out[3]))


@pytest.mark.parametrize("solver,option", [
    ("RSQO", {"maxiter": 30, "tolresid": 1e-8}),
    ("RALM", {"maxiter": 10, "tolresid": 1e-4}),
    ("RIPTRM", {"maxiter": 20, "tolresid": 1e-6}),  # exact mode, second order
])
def test_export_other_solvers(tmp_path, solver, option):
    """RSQO (the QP's loops), RALM (its subsolver's) and RIPTRM's exact
    mode (the Moré-Sorensen loop) export too, equal to the direct sweep."""
    (tp, txs, tys), _ = _both()
    run, _ = _port_artifact(tmp_path, tp, solver, option, B, 40)
    out = _np(run(txs, tys))
    direct = _np(batched_solver_sweep(tp, solver, option, 40)(txs, tys))
    for a, d in zip(out, direct):
        np.testing.assert_array_equal(a, d)
    assert np.all(np.isfinite(out[3]))


def test_reload_in_fresh_process(tmp_path):
    """A process that never traced the solver loads the artifact (and with
    it the riptrm:: operators) and gets the exporting process's results."""
    (tp, txs, tys), _ = _both(1)
    option = {"maxiter": 20, "tolresid": 1e-6, "use_fused_tcg": True, **TCG}
    run, _ = _port_artifact(tmp_path, tp, "RIPTRM", option, B, 200)
    want = _np(run(txs, tys))[3]
    torch.save((txs, tys), tmp_path / "inputs.pt")
    code = (
        "import json, torch; torch.set_num_threads(1); "
        "from riptrm_torch.experiment.export_artifact import load_sweep; "
        f"run, _ = load_sweep({str(tmp_path / 'sweep.pt2')!r}); "
        f"xs, ys = torch.load({str(tmp_path / 'inputs.pt')!r}); "
        "print(json.dumps(run(xs, ys)[3].tolist()))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.array(json.loads(proc.stdout.splitlines()[-1])), want)


def test_export_refuses_another_device(tmp_path):
    (tp, _, _), _ = _both()
    with pytest.raises(ValueError, match="lies on cpu"):
        tea.export_sweep(tp, "RIPTRM", TCG, str(tmp_path / "x.pt2"), batch=B, max_steps=5,
                         device="meta")


def _traced(fn, args):
    """``fn`` as the exported program runs it."""
    return tea.trace_program(fn, args).module()


def test_lane_loop_traced_matches_eager_tcg():
    """truncated_cg with the closed-form sphere Hessian: traced (one
    while_loop) and eager (a Python loop) bit for bit, every stop code."""
    from riptrm_torch.manifolds import Sphere
    from riptrm_torch.ops import kernels
    from riptrm_torch.ops.tcg import truncated_cg

    z, xs, _ = _inputs(2)
    zs = torch.tensor(z)
    xs = torch.tensor(xs)
    ws = torch.rand(B, N, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    grads = Sphere(N).proj(xs, torch.randn(B, N, dtype=torch.float64,
                                           generator=torch.Generator().manual_seed(1)))
    radii = torch.tensor([1e-3, 1e-1, 1.0, 10.0], dtype=torch.float64)

    def tcg(xs, grads, radii):
        hw = kernels.sphere_hw(zs, xs, ws, kernels.barrier_corr(zs, xs, ws))
        return truncated_cg(Sphere(N), xs, hw, grads, radii, maxinner=N)

    eager = tcg(xs, grads, radii)
    traced = _traced(tcg, (xs, grads, radii))(xs, grads, radii)
    for a, b in zip(traced, eager):
        assert torch.equal(a, b)
    assert len(set(eager[3].tolist())) > 1  # lanes stop on different tests


def test_lane_loop_traced_matches_eager_best_while():
    """compiled_best_while under RIPTRM (the fused tCG's plain version on
    the CPU), with the stall window and the best-state tracking on: traced
    and eager bit for bit."""
    (tp, txs, tys), _ = _both(3)
    option = {"maxiter": 20, "tolresid": 1e-6, "use_fused_tcg": True, "keep_best_point": True,
              "sweep_stall_window": 5, **TCG}
    fn = batched_solver_sweep(tp, "RIPTRM", option, 60)
    eager = fn(txs, tys)
    traced = _traced(fn, (txs, tys))(txs, tys)
    for a, b in zip(traced, eager):
        assert torch.equal(a, b)

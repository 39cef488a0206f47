"""The port's scale-out on ``torch.distributed`` against ``riptrm_tpu``.

Two real processes join a gloo group through a ``file://`` rendezvous under
``tmp_path`` (``riptrm_torch/parallel/dryrun.py``'s workers, one thread
each, every worker with its own 120 s timeout), float64 on the CPU; the
JAX package runs in this process on conftest's 8 virtual devices.  In one
spawn of two ranks: ``run_sweep(mesh=)`` over dp = 2 against the JAX
package's vmapped ``run_sweep`` (every lane below 1e-3, residuals within
rtol 5e-2, x within atol 1e-4, as ``tests/test_parallel.py``), with
``host_shard`` and the all-gathered residuals equal on both ranks
(``tests/test_distributed.py``); NonnegPCA with Zs's rows split over tp = 2
against the same JAX sweep at the same tolerances, and its first step
against the JAX package's unsharded step (rtol 1e-9), no kernel launched; ``materialize_sharded`` on
``dataset/StableIdentification/1`` (dim 40) against the JAX
``materialize_symmetrized`` (atol 1e-10); the data-sharded solve of that
instance (95 trajectory columns: one pad column at two ranks) against the
JAX unsharded solve at the JAX test's tolerances; and the checkpointed
sweep killed at world size 2 and resumed at world size 1, and the reverse.
Then the dry run at world size 2 (dp x tp = 1 x 2), and the refusals, in
this process: NCCL with two ranks on one card, a batch or a dim that the
axis does not divide, a mesh that does not span the world; and the
tp-sharded NonnegPCA, which carries no structure, so that its fused route
is the plain tCG.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from riptrm_torch.ops import kernels as tk
from riptrm_torch.ops.basis import materialize_sharded
from riptrm_torch.parallel import distributed as td
from riptrm_torch.parallel import dryrun
from riptrm_torch.parallel import sweep as ts
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.problems import stable_identification as tsi
from riptrm_torch.solvers import riptrm as trm
from riptrm_tpu.ops.basis import materialize_symmetrized
from riptrm_tpu.ops.kkt import compute_residual as jresidual
from riptrm_tpu.parallel.sweep import run_sweep as jrun_sweep
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.problems import stable_identification as jsi
from riptrm_tpu.solvers.riptrm import RIPTRM as JRIPTRM
from riptrm_tpu.solvers.riptrm import init_state as jinit_state
from riptrm_tpu.solvers.riptrm import make_step as jmake_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SID = os.path.join(REPO, "dataset", "StableIdentification", "1")
N, BATCH = 16, 8
OPTION = {"maxiter": 12, "tolresid": 1e-7, "TRS_solver": "tCG",
          "second_order_stationarity": False}
CKPT_OPTION = OPTION | {"tolresid": 1e-6, "maxiter": 30}
CKPT = dict(max_steps=300, segment_steps=20)
SID_OPTION = {"maxiter": 40, "tolresid": 1e-6, "TRS_solver": "tCG",
              "second_order_stationarity": False}


class FakeMesh:
    """The attributes ``collectives.mesh_axis`` reads: for the refusals,
    which raise before any collective."""

    def __init__(self, **axes):
        self.mesh_dim_names, self.shape = tuple(axes), tuple(axes.values())

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


@pytest.fixture(scope="module")
def inputs():
    """tests/test_parallel.py's instance and starts (numpy)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    z = np.asarray(jn.generate_instance(k1, N)["Z"])
    xs = np.abs(np.asarray(jax.random.normal(k2, (BATCH, N))))
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    return z, xs, np.ones((BATCH, N))


@pytest.fixture(scope="module")
def jax_sweep(inputs):
    """The JAX package's unsharded ``run_sweep`` of those starts: (x, res)."""
    z, xs, ys = inputs
    jx, _, _, jres = jrun_sweep(jn.make_problem(z, xs[0]), OPTION, jnp.asarray(xs),
                                jnp.asarray(ys), max_steps=300)
    return np.asarray(jx), np.asarray(jres)


def _port_problem(inputs):
    z, xs, _ = inputs
    return tn.make_problem(z, xs[0], dtype=torch.float64, device="cpu")


class Kill(Exception):
    pass


def _kill_after_first(n_seg, steps, res, done):
    if n_seg == 1:
        raise Kill


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    """One spawn of two ranks running every task; the world-size-1 half of
    the checkpoint round trip runs here (no mesh) before and after it."""
    tmp = tmp_path_factory.mktemp("world2")
    z, xs, ys = inputs
    npz = str(tmp / "nonneg.npz")
    np.savez(npz, Z=z, xs=xs, ys=ys)
    problem = _port_problem(inputs)
    # killed at world size 1: resumed by the two ranks below
    with pytest.raises(Kill):
        ts.run_sweep_checkpointed(problem, CKPT_OPTION, xs, ys, checkpoint_path=str(tmp / "b.npz"),
                                  on_segment=_kill_after_first, **CKPT)
    sid_npz = str(tmp / "sid.npz")
    trajs = np.stack([np.loadtxt(f"{SID}/noisyX_{i}.csv") for i in range(1, 6)])
    np.savez(sid_npz, trajs=trajs, constset=np.loadtxt(f"{SID}/constset.csv"),
             y0=np.loadtxt(f"{SID}/initineqLagmult.csv"),
             **{k: np.loadtxt(f"{SID}/init{k}_a.csv") for k in "JRQ"})
    f64 = {"dtype": "float64"}
    nonneg = f64 | {"inputs": npz}
    sid = f64 | {"dataset": sid_npz}
    tasks = [
        ("sweep", nonneg | {"option": OPTION, "max_steps": 300}),
        ("nonneg_tp", nonneg | {"option": OPTION, "max_steps": 300}),
        ("checkpoint", nonneg | {"label": "kill_a", "option": CKPT_OPTION, "kill_after": 1,
                                 "path": str(tmp / "a.npz")} | CKPT),
        ("checkpoint", nonneg | {"label": "resume_b", "option": CKPT_OPTION,
                                 "path": str(tmp / "b.npz")} | CKPT),
        ("materialize", sid),
        ("stableid", sid | {"option": SID_OPTION, "max_steps": 200}),
    ]
    ranks = dryrun.run_tasks(2, tasks, str(tmp / "out"), device="cpu")
    # killed at world size 2: resumed here at world size 1
    resumed_a = ts.run_sweep_checkpointed(problem, CKPT_OPTION, xs, ys,
                                          checkpoint_path=str(tmp / "a.npz"), **CKPT)
    return ranks, resumed_a


def test_sharded_sweep_matches_vmap(world2, jax_sweep):
    jx, jres = jax_sweep
    out = world2[0][0]
    assert out["sweep.res"].shape == (BATCH,) and out["sweep.x"].shape == (BATCH, N)
    np.testing.assert_allclose(out["sweep.res"], jres, rtol=5e-2)
    assert np.all(out["sweep.res"] < 1e-3)
    np.testing.assert_allclose(out["sweep.x"], jx, atol=1e-4)


def test_tp_sharded_nonneg_matches_unsharded(inputs, world2, jax_sweep):
    """Zs's rows split over tp = 2 (8 rows a rank), the fused tCG asked
    for: the sweep against the JAX package's unsharded sweep, and one step
    against its unsharded step; no structure, so no kernel is launched."""
    jx, jres = jax_sweep
    z, xs, _ = inputs
    jp = jn.make_problem(z, xs[0])
    jopt = JRIPTRM(OPTION).option
    j_new, j_info = jax.jit(jmake_step(jp, jopt))(jinit_state(jp, jopt))
    r0, r1 = world2[0]
    for r in (r0, r1):
        assert not r["nonneg_tp.structured"]
        assert not any(v for k, v in r.items() if k.startswith("nonneg_tp.launches."))
        np.testing.assert_allclose(r["nonneg_tp.res"], jres, rtol=5e-2)
        assert np.all(r["nonneg_tp.res"] < 1e-3)
        np.testing.assert_allclose(r["nonneg_tp.x"], jx, atol=1e-4)
        np.testing.assert_allclose(r["nonneg_tp.step_x"], np.asarray(j_new.x), rtol=1e-9,
                                   atol=1e-15)
        np.testing.assert_allclose(r["nonneg_tp.step_residual"], float(j_info["residual"]),
                                   rtol=1e-9)
    np.testing.assert_array_equal(r0["nonneg_tp.res"], r1["nonneg_tp.res"])


def test_two_process_sharded_sweep(world2):
    r0, r1 = world2[0]
    shards = [set(r["sweep.host_shard"].tolist()) for r in (r0, r1)]
    assert shards[0] | shards[1] == set(range(7)) and not shards[0] & shards[1]
    np.testing.assert_array_equal(r0["sweep.res"], r1["sweep.res"])
    np.testing.assert_array_equal(r0["sweep.x"], r1["sweep.x"])
    assert np.all(r0["sweep.res"] < 1e-3)
    assert not any(v for k, v in r0.items() if k.startswith("sweep.launches."))


def test_sharded_materialization(world2):
    """Each rank materialises 20 of the 40 columns, the Product's bases cut
    across components (Skew 10 + SPD 10 | SPD 5 + SPD 15)."""
    problem = jsi.load_problem(SID, "a")
    man, x = problem.manifold, problem.x0
    dense = materialize_symmetrized(man, x, man.basis(x), problem.lag_rhess_at(x, problem.y0))
    for r in world2[0]:
        sharded = r["materialize.sharded"]
        np.testing.assert_allclose(0.5 * (sharded + sharded.T), np.asarray(dense), atol=1e-10)
        np.testing.assert_allclose(sharded, r["materialize.dense"], rtol=0, atol=1e-12)


def test_stableid_data_sharded_solve_matches(world2):
    plain = jsi.load_problem(SID, "a")
    solver = JRIPTRM(SID_OPTION)
    st, _ = jax.jit(solver.solve_compiled(plain, max_steps=200))(
        jinit_state(plain, solver.option))
    res_p = float(jresidual(plain, st.x, st.y, jnp.zeros((0,)))[0])
    for r in world2[0]:
        res_s = float(r["stableid.residual"])
        assert res_s < 1e-5
        np.testing.assert_allclose(res_s, res_p, rtol=5e-2)
        x = tuple(jnp.asarray(r["stableid.x"][i]) for i in range(3))
        np.testing.assert_allclose(float(plain.cost(x)), float(plain.cost(st.x)), rtol=1e-4)
        np.testing.assert_allclose(float(r["stableid.cost"]), float(plain.cost(x)), rtol=1e-10)


def test_checkpointed_sweep_sharded(world2):
    """Killed at world size 2 after its first segment and resumed at world
    size 1, and killed at world size 1 and resumed at world size 2."""
    ranks, (x_a, _, ks_a, res_a) = world2
    assert all(int(r["kill_a.killed"]) == 1 for r in ranks)
    assert np.all(res_a.numpy() < 1e-6) and bool((ks_a > 20).all())
    r0, r1 = ranks
    assert int(r0["resume_b.killed"]) == 0
    np.testing.assert_array_equal(r0["resume_b.res"], r1["resume_b.res"])
    assert np.all(r0["resume_b.res"] < 1e-6) and np.all(r0["resume_b.ks"] > 20)
    np.testing.assert_allclose(r0["resume_b.x"], x_a.numpy(), atol=1e-4)


def test_dryrun_world_two():
    """``python -m riptrm_torch.parallel.dryrun --world 2 --device cpu``'s
    workers: every rank's checks pass and it exits 0."""
    outs = dryrun.spawn(2, ["--device", "cpu"])
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert '"dryrun.res"' in out


def test_refusal_nccl_two_ranks_on_one_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        td.initialize(f"file://{tmp_path / 'rv'}", 2, 0)
    assert not dist.is_initialized()


def test_refusal_lanes_not_divisible(inputs):
    problem = _port_problem(inputs)
    _, xs, ys = inputs
    fn = ts.sharded_riptrm_solve(problem, OPTION, 10, FakeMesh(dp=3))
    with pytest.raises(ValueError, match="not divisible by the axis size 3"):
        fn(torch.tensor(xs), torch.tensor(ys))


def test_refusal_dim_not_divisible():
    problem = tsi.load_problem(SID, "a", device="cpu")
    man, x = problem.manifold, problem.x0[None]
    with pytest.raises(ValueError, match="40 is not divisible by the axis size 3"):
        materialize_sharded(man, x, man.basis(x), problem.lag_rhess_at(x, problem.y0[None]),
                            FakeMesh(tp=3))


@pytest.fixture
def group1(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    td.initialize(f"file://{tmp_path / 'rv'}", 1, 0, device="cpu")
    yield
    dist.destroy_process_group()


def test_refusal_mesh_must_span_the_world(group1):
    with pytest.raises(ValueError, match="has 2 ranks, the world 1"):
        ts.make_mesh({"dp": 2}, "cpu")
    assert ts.make_mesh({"dp": 1}, "cpu").mesh_dim_names == ("dp",)


def test_tp_sharded_nonneg_takes_plain_tcg(group1, inputs, monkeypatch):
    """A Zs split over tp carries no structure: the fused route is the
    plain ``truncated_cg`` and no kernel is called or counted; its step is
    the unsharded plain step."""
    z, xs, ys = inputs
    mesh = ts.make_mesh({"dp": 1, "tp": 1}, "cpu")
    p = tn.make_problem(z, xs[0], dtype=torch.float64, device="cpu", mesh=mesh, axis="tp")
    assert p.structure is None
    opt = trm.RIPTRM(OPTION | {"use_fused_tcg": True}).option
    st0 = ts.init_state_from(p, opt, torch.tensor(xs), torch.tensor(ys))
    c0 = p.slack(st0.x)
    assert p.fused_tcg_at(st0.x, st0.y, c0) is None
    # the same manifold and lanes with the whole Zs take the kernel
    assert _port_problem(inputs).fused_tcg_at(st0.x, st0.y, c0) is not None
    for name in ("fused_tcg_sphere_quadratic", "fused_tcg_sphere_quadratic_batched"):
        monkeypatch.setattr(tk, name, lambda *a, **k: pytest.fail("a kernel was called"))
    tk.reset_launch_counts()
    new, _ = trm.make_step(p, opt)(st0)
    assert not any(tk.launch_counts().values())
    plain = _port_problem(inputs)
    ref, _ = trm.make_step(plain, trm.RIPTRM(OPTION).option)(
        ts.init_state_from(plain, opt, torch.tensor(xs), torch.tensor(ys)))
    np.testing.assert_allclose(new.x.numpy(), ref.x.numpy(), rtol=1e-12, atol=1e-14)

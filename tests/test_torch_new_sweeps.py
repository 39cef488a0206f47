"""The four solvers on the new families through ``run`` and the sweeps of
the PyTorch port, float64 on the CPU.

Every solver that runs on a family in the JAX package runs in the port
through its entry points: RIPTRM (tCG, and exact mode where a basis
exists), RIPM, RSQO and RALM on Rosenbrock and StableIdentification;
RIPTRM's tCG, RIPM's conjugate residual and RALM on LowRank.  ``run`` for
two iterations (RIPTRM's cut to 10 inner steps each), finite, and ``batched_solver_sweep`` over two starts packed
[B, ...] for a few steps, each against the same lanes in the JAX package
(its tuple points carried across): the residual of every lane to rtol
1e-6 for RIPTRM, RIPM and RSQO after their first steps (inf where the
JAX lane is inf); RALM, whose
subsolver follows the rounding (ROADMAP.md queue 3), below its starting
residual.  ``certify_second_order`` runs on the sweep's final points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops.kkt import compute_residual
from riptrm_torch.parallel import sweep as tsw
from riptrm_torch.problems import low_rank as tl
from riptrm_torch.problems import rosenbrock as tr
from riptrm_torch.problems import stable_identification as ts
from riptrm_torch.solvers import RALM, RIPM, RIPTRM, RSQO
from riptrm_tpu.parallel import sweep as jsw
from riptrm_tpu.problems import low_rank as jl
from riptrm_tpu.problems import rosenbrock as jr

torch.set_num_threads(1)

CPU = dict(dtype=torch.float64, device="cpu")
TCG = {"TRS_solver": "tCG", "second_order_stationarity": False}
OPTIONS = {
    "RIPTRM": TCG | {"maxiter": 30, "tolresid": 1e-8},
    "RIPTRM_exact": {"maxiter": 30, "tolresid": 1e-8},
    "RIPM": {"maxiter": 30, "tolresid": 1e-8},
    "RIPM_CR": {"maxiter": 30, "tolresid": 1e-8, "KrylovIterMethod": True},
    "RSQO": {"maxiter": 20, "tolresid": 1e-8, "quadoptim_eigvalcorr": 1e-2},
    "RALM": {"maxiter": 2, "tolresid": 1e-8, "maxInnerIter": 20},
}
SOLVERS = {"RIPTRM": RIPTRM, "RIPM": RIPM, "RSQO": RSQO, "RALM": RALM}
RUNS = [("rosenbrock", s) for s in ("RIPTRM", "RIPTRM_exact", "RIPM", "RSQO", "RALM")] + \
       [("lowrank", s) for s in ("RIPTRM", "RIPM_CR", "RALM")]


def family(name):
    """(jax problem, torch problem, two starts as numpy components, ys)."""
    rng = np.random.default_rng(3)
    if name == "rosenbrock":
        jp, tp = jr.make_problem(5, 3), tr.make_problem(5, 3, **CPU)
        v = rng.standard_normal((2, 5, 3))
        xs = []
        for vi in v:  # small retractions of x0, as chip_sweep draws them
            t = np.asarray(jp.manifold.proj(jp.x0, jnp.asarray(vi)))
            xs.append(np.asarray(jp.manifold.retract(jp.x0, 5e-3 * t / np.linalg.norm(t))))
        parts = (np.stack(xs),)
    else:
        jp = jl.load_problem("dataset/LowRank/1", "a")
        tp = tl.load_problem("dataset/LowRank/1", "a", **CPU)
        starts = [tuple(np.atleast_1d(np.loadtxt(f"dataset/LowRank/1/init{c}_{p}.csv"))
                        for c in "USV") for p in "ab"]
        m, n, k = 12, 10, 3
        shapes = ((m, k), (k,), (n, k))
        parts = tuple(np.stack([s[i].reshape(shapes[i]) for s in starts]) for i in range(3))
    ys = np.ones((2, tp.num_ineq))
    return jp, tp, parts, ys


@pytest.mark.parametrize("name,solver", RUNS)
def test_run_two_iterations(name, solver):
    _, tp, _, _ = family(name)
    cls = SOLVERS[solver.split("_")[0]]
    # RIPTRM's outer iterations on Rosenbrock run ~80 inner steps each:
    # inner_maxiter cuts them to 10
    out = cls(OPTIONS[solver] | {"maxiter": 2, "inner_maxiter": 10, "maxtime": 60,
                                 "do_exit_on_error": False}).run(tp)
    res = out.log["residual"]
    assert len(res) >= 2 and all(np.isfinite(r) for r in res)
    assert out.x.shape == tp.x0.shape


@pytest.mark.parametrize("name,solver", RUNS)
def test_sweep_against_jax(name, solver):
    jp, tp, parts, ys = family(name)
    base = solver.split("_")[0]
    steps = 2 if base == "RALM" else 3
    txs = tp.manifold.pack(tuple(torch.tensor(a) for a in parts))
    t_x, _, _, t_res = tsw.batched_solver_sweep(tp, base, OPTIONS[solver], steps)(
        txs, torch.tensor(ys))
    assert t_x.shape == txs.shape
    if base == "RALM":
        assert bool(torch.isfinite(t_res).all())
        assert bool((t_res < compute_residual(tp, txs, torch.tensor(ys))[0]).all())
        return
    jxs = tuple(jnp.asarray(a) for a in parts) if len(parts) > 1 else jnp.asarray(parts[0])
    _, _, _, j_res = jsw.batched_solver_sweep(jp, base, OPTIONS[solver], steps)(
        jxs, jnp.asarray(ys))
    # equal where infinite too: RSQO takes one Rosenbrock lane to a frame
    # of lower rank, whose manifold violation is inf, in both packages
    np.testing.assert_allclose(t_res.numpy(), np.asarray(j_res), rtol=1e-6)


def test_sid_runs_and_certificates():
    """RIPM, RSQO and RALM through ``run`` on StableIdentification, and
    ``certify_second_order`` on a RIPTRM sweep's final points."""
    tp = ts.load_problem("dataset/StableIdentification/1", "a", **CPU)
    for cls, opt in ((RIPM, OPTIONS["RIPM"]), (RSQO, OPTIONS["RSQO"]),
                     (RALM, OPTIONS["RALM"])):
        out = cls(opt | {"maxiter": 2, "maxtime": 60, "do_exit_on_error": False}).run(tp)
        assert all(np.isfinite(r) for r in out.log["residual"])
    xs = tp.x0[None].expand(2, *tp.x0.shape).clone()
    ys = tp.y0[None].expand(2, -1).clone()
    st, _, res = tsw.batched_riptrm_solve(tp, OPTIONS["RIPTRM"], 5)(xs, ys)
    ritz = tsw.certify_second_order(tp, st.x, st.y, num_iters=8)
    assert ritz.shape == (2,) and bool(torch.isfinite(ritz).all())
    assert bool(torch.isfinite(res).all())

"""The solver-generic sweeps of the PyTorch port (``parallel/sweep.py``:
``batched_solver_sweep``, ``batched_protocol_sweep``, ``protocol_single``)
for the four solvers, float64 on the CPU.

An n = 12 NonnegPCA instance from a seeded numpy generator and three
feasible starts (y = 1).  (a) Each solver's sweep at B = 3 against each
lane run alone through the same entry point at B = 1, and against the JAX
package's vmapped sweep on the same starts.  A lane's values depend on
that lane alone, but not bit for bit: a batched product may sum in
another order than a one-lane product, and the solvers amplify such
rounding differently.  RIPM and RSQO: steps equal, residuals to rtol 1e-6
(atol 1e-14) and points to 1e-8.  RIPTRM: its tCG's accept/reject
decisions follow the rounding (87 or 89 steps on lane 0), so the lanes
are held to the same KKT point, x to 1e-6 with every residual below
tolresid.  RALM: the subsolver's iteration counts follow the rounding
(``tests/test_torch_ralm.py``), so after its 4 outer steps the lanes are
held to 1e-2 in the residual and 1e-3 in x.  (b) The protocol sweep with
per-lane targets stops each lane at its target, in the steps the lane
alone needs (``protocol_single``); a target at the starting residual
stops its lane at once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.parallel import sweep as tsw
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_tpu.parallel import sweep as jsw
from riptrm_tpu.problems import nonneg_pca as jn

torch.set_num_threads(1)
N, B = 12, 3
OPTIONS = {
    "RIPTRM": ({"maxiter": 30, "tolresid": 1e-8, "TRS_solver": "tCG",
                "second_order_stationarity": False}, 200),
    "RIPM": ({"maxiter": 30, "tolresid": 1e-8}, 30),
    "RSQO": ({"maxiter": 20, "tolresid": 1e-8, "quadoptim_eigvalcorr": 1e-2}, 20),
    "RALM": ({"maxiter": 4, "tolresid": 1e-8}, 4),
}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    v = (rng.permutation(N) < 8) / np.sqrt(8)
    z = np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((N, N)) / np.sqrt(N)
    xs = np.abs(rng.standard_normal((B, N)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    ys = np.ones((B, N))
    jp = jn.make_problem(jnp.asarray(z), jnp.asarray(xs[0]))
    tp = tn.make_problem(z, xs[0], device="cpu")
    return jp, tp, xs, ys


def _same(solver, option, k, res, x, k_ref, res_ref, x_ref):
    k, res, x = np.asarray(k), np.asarray(res), np.asarray(x)
    if solver in ("RIPM", "RSQO"):
        assert k.tolist() == np.asarray(k_ref).tolist()
        np.testing.assert_allclose(res, res_ref, rtol=1e-6, atol=1e-14)
        np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-10)
    elif solver == "RIPTRM":
        assert np.all(res <= option["tolresid"]) and np.all(np.asarray(res_ref) <= option["tolresid"])
        np.testing.assert_allclose(x, x_ref, rtol=1e-6, atol=1e-8)
    else:
        np.testing.assert_allclose(res, res_ref, rtol=1e-2)
        np.testing.assert_allclose(x, x_ref, atol=1e-3)


@pytest.mark.parametrize("solver", OPTIONS)
def test_sweep_lanes_match_alone_and_jax(setup, solver):
    jp, tp, xs, ys = setup
    option, steps = OPTIONS[solver]
    run = tsw.batched_solver_sweep(tp, solver, option, steps)
    x, ineq, k, res = run(torch.tensor(xs), torch.tensor(ys))
    assert x.shape == (B, N) and ineq.shape == (B, N)
    alone = [run(torch.tensor(xs[i:i + 1]), torch.tensor(ys[i:i + 1])) for i in range(B)]
    _same(solver, option, k, res, x, [int(a[2][0]) for a in alone],
          [float(a[3][0]) for a in alone], np.stack([a[0][0].numpy() for a in alone]))
    jx, _, jk, jres = jsw.batched_solver_sweep(jp, solver, option, steps)(
        jnp.asarray(xs), jnp.asarray(ys))
    _same(solver, option, k, res, x, jk, jres, jx)


@pytest.mark.parametrize("solver", ["RIPTRM", "RIPM", "RSQO"])
def test_protocol_sweep_stops_lanes_at_their_targets(setup, solver):
    _, tp, xs, ys = setup
    option, steps = OPTIONS[solver]
    full = tsw.batched_solver_sweep(tp, solver, option, steps)
    _, _, k_full, res_full = full(torch.tensor(xs), torch.tensor(ys))
    # lane 0: a target at its starting residual (one part in 1e12 above,
    # as a one-lane evaluation may round it differently); lanes 1-2: the
    # geometric mean of their starting and final residuals
    res0 = tsw.batched_solver_sweep(tp, solver, option, 0)(torch.tensor(xs), torch.tensor(ys))[3]
    targets = torch.cat([res0[:1] * (1 + 1e-12), torch.sqrt(res0[1:] * res_full[1:])])
    proto = tsw.batched_protocol_sweep(tp, solver, option, steps)
    x, _, k, best = proto(torch.tensor(xs), torch.tensor(ys), targets)
    assert int(k[0]) == 0
    assert bool(torch.all(best <= targets))
    assert bool(torch.all(k[1:] <= k_full[1:])) and bool(torch.any(k[1:] < k_full[1:]))
    single = tsw.protocol_single(tp, solver, option, steps)
    for i in range(B):
        x1, _, k1, best1 = single(torch.tensor(xs[i]), torch.tensor(ys[i]), float(targets[i]))
        # one lane against three: the rounding of (a), to rtol 1e-6
        assert int(k1) == int(k[i])
        np.testing.assert_allclose(float(best1), float(best[i]), rtol=1e-6, atol=1e-14)
        np.testing.assert_allclose(x1.numpy(), x[i].numpy(), rtol=1e-6, atol=1e-10)


def test_unknown_solver_raises(setup):
    with pytest.raises(ValueError, match="Unknown solver"):
        tsw.batched_solver_sweep(setup[1], "IPOPT", {}, 10)

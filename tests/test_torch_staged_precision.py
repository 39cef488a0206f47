"""Staged precision in the port against ``riptrm_tpu``, on the CPU.

``matmul_precision`` on NonnegPCA and StableIdentification is scoped to the
problem's operators: the process's float32 matmul precision is as it was
after every call, and on the CPU 'high' and 'highest' compute the same
float32 values (as XLA does on the CPU).  ``staged_precision_riptrm_solve``
(NonnegPCA n = 16, B = 4, float64, the JAX test's options) and
``staged_precision_ripm_solve`` (the same instance, dense RIPM) are held
to the JAX functions on the same numpy inputs; ``chip_sweep --precision``
and ``--staged-precision`` run.
"""

import contextlib
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.experiment import chip_sweep as tcs
from riptrm_torch.parallel import sweep as ts
from riptrm_torch.problems import nonneg_pca as tn
from riptrm_torch.problems import problem as tproblem
from riptrm_torch.problems import stable_identification as tsi
from riptrm_tpu.parallel import sweep as js
from riptrm_tpu.problems import nonneg_pca as jn

torch.set_num_threads(1)

N, B = 16, 4
OPTION = {"maxiter": 12, "tolresid": 1e-7, "TRS_solver": "tCG",
          "second_order_stationarity": False}


@pytest.fixture(scope="module")
def instance():
    rng = np.random.default_rng(2)
    v = (rng.permutation(N) < int(0.7 * N)) / np.sqrt(int(0.7 * N))
    z = np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((N, N)) / np.sqrt(N)
    xs = np.abs(rng.standard_normal((B, N)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    return z, xs, np.ones((B, N))


def test_matmul_precision_is_scoped(instance, monkeypatch):
    """A 'high' problem's operators run under 'high' (so do the operators its
    point-frozen factories return), and the process's setting is as it was
    after each call, an exception included; on the CPU the values equal
    'highest''s."""
    z, xs, ys = instance
    before = torch.get_float32_matmul_precision()
    f32 = dict(dtype=torch.float32, device="cpu")
    hi = tn.make_problem(z, xs[0], matmul_precision="high", **f32)
    full = tn.make_problem(z, xs[0], matmul_precision="highest", **f32)
    x = torch.tensor(xs, **f32)
    y = torch.tensor(ys, **f32)
    seen = []
    inner = hi.cost_fn

    def recording(xl, *data):
        seen.append(torch.get_float32_matmul_precision())
        return inner(xl, *data)

    dataclasses.replace(hi, cost_fn=recording).cost(x)
    assert seen and set(seen) == {"high"}
    assert torch.get_float32_matmul_precision() == before

    entered = []
    real = tproblem._precision_scope

    @contextlib.contextmanager
    def spy(p):
        entered.append(p)
        with real(p):
            yield

    monkeypatch.setattr(tproblem, "_precision_scope", spy)
    hvp = hi.lag_rhess_at(x, y)
    entered.clear()
    v = hi.manifold.proj(x, torch.ones_like(x))
    out = hvp(v)
    assert entered == ["high"]  # the frozen operator runs in the scope too
    assert torch.get_float32_matmul_precision() == before
    np.testing.assert_array_equal(out.numpy(), full.lag_rhess_at(x, y)(v).numpy())
    for name in ("cost", "rgrad", "slack"):
        np.testing.assert_array_equal(getattr(hi, name)(x).numpy(),
                                      getattr(full, name)(x).numpy())

    def boom(xl, *data):
        raise RuntimeError("inside the scope")

    with pytest.raises(RuntimeError):
        dataclasses.replace(hi, cost_fn=boom).cost(x)
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError, match="matmul_precision"):
        tn.make_problem(z, xs[0], matmul_precision="medium", **f32)


def test_stable_identification_takes_high():
    from riptrm_tpu.experiment.chip_sweep import _cache_load, _generate_payload

    payload = (_cache_load("StableIdentification", 3, 2, 11)
               or _generate_payload("StableIdentification", 3, 2, 11))
    comps = (payload["b_J"], payload["b_R"], payload["b_Q"])
    args = (3, list(payload["trajs"]), payload["constset"], tuple(a[0] for a in comps))
    kw = dict(dtype=torch.float32, device="cpu")
    hi = tsi.make_problem(*args, matmul_precision="high", **kw)
    full = tsi.make_problem(*args, **kw)
    x = hi.manifold.pack(tuple(torch.tensor(a, **kw) for a in comps))
    np.testing.assert_array_equal(hi.cost(x).numpy(), full.cost(x).numpy())
    np.testing.assert_array_equal(hi.egrad(x).numpy(), full.egrad(x).numpy())


def test_staged_precision_sweep_deepens_floor(instance):
    """Phase 2 continues phase 1's states under the tighter program and
    deepens every lane; phase 1 agrees with the JAX package's lane by lane
    (rtol 1e-4: its residual near 2.2e-4 moves by ~7e-6 relative under
    roundoff), phase 2 meets the JAX test's criteria in both packages."""
    z, xs, ys = instance
    opt1 = OPTION | {
        "tolresid": 3e-4,
        "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
        "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-4),
    }
    opt2 = OPTION | {
        "tolresid": 1e-6,
        "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-6),
        "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-6),
        "sweep_stall_window": 25,
    }
    tp = tn.make_problem(z, xs[0], device="cpu")
    staged = ts.staged_precision_riptrm_solve(tp, tp, opt1, opt2, 300)
    st, ks, res2, res1 = staged(torch.tensor(xs), torch.tensor(ys))
    jopt1 = opt1 | {
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": lambda mu: jnp.maximum(1e-3 * mu, 2e-4),
    }
    jopt2 = opt2 | {
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-6),
        "forcing_function_complementarity": lambda mu: jnp.maximum(1e-3 * mu, 2e-6),
    }
    jp = jn.make_problem(z, xs[0])
    _, _, jres2, jres1 = js.staged_precision_riptrm_solve(jp, jp, jopt1, jopt2, 300)(
        jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_allclose(res1.numpy(), np.asarray(jres1), rtol=1e-4)
    for r1, r2 in ((res1.numpy(), res2.numpy()), (np.asarray(jres1), np.asarray(jres2))):
        assert np.all(r1 < 1e-3) and np.all(r2 < r1)
        assert np.median(r2) < np.median(r1) / 10
    assert torch.all(ks > 0)  # phase 2's churn at its floor sets the step counts
    np.testing.assert_allclose(torch.linalg.vector_norm(st.x, dim=1).numpy(), 1.0, atol=1e-10)


def test_staged_precision_ripm_solve(instance):
    """The two-phase RIPM continuation composes and hands back no lane worse
    than its phase-1 state (keep_best_point: the JAX test's criterion), the
    second phase on the 'highest' problem; both phases agree with the JAX
    package's lane by lane (float64, dense RIPM: steps equal, residuals
    rtol 1e-6).  (The JAX test's StableIdentification float32 Krylov run
    takes ~2 min in the port on the CPU and parts from the JAX run in
    float32, so the function is held here in float64 on NonnegPCA.)"""
    z, xs, ys = instance
    lo = tn.make_problem(z, xs[0], device="cpu")
    hi = tn.make_problem(z, xs[0], matmul_precision="highest", device="cpu")
    option_lo = {"maxiter": 60, "tolresid": 1e-3}
    option_hi = {"maxiter": 60, "tolresid": 1e-7}
    staged = ts.staged_precision_ripm_solve(lo, hi, option_lo, option_hi, 60)
    _, ks, res2, res1 = staged(torch.tensor(xs), torch.tensor(ys))
    assert res1.shape == res2.shape == (B,)
    r1, r2 = res1.numpy(), res2.numpy()
    assert np.all(r2 <= r1 * (1.0 + 1e-4)), (r1, r2)
    assert np.median(r2) < np.median(r1) / 10

    jp = jn.make_problem(z, xs[0])
    jhi = jn.make_problem(z, xs[0], matmul_precision="highest")
    _, jks, jres2, jres1 = js.staged_precision_ripm_solve(jp, jhi, option_lo, option_hi, 60)(
        jnp.asarray(xs), jnp.asarray(ys))
    assert ks.tolist() == np.asarray(jks).tolist()
    np.testing.assert_allclose(r1, np.asarray(jres1), rtol=1e-6)
    np.testing.assert_allclose(r2, np.asarray(jres2), rtol=1e-6)


def test_chip_sweep_precision_and_staged_flags(capsys):
    """``--precision high`` builds the 'high' problem; ``--staged-precision``
    reports both phases, and no lane ends phase 2 above its phase 1."""
    base = ["--problem", "NonnegPCA", "--size", "32", "--batch", "4", "--reps", "1",
            "--device", "cpu"]
    out = tcs.main(base + ["--precision", "high", "--max-steps", "60"])
    assert out["precision"] == "high" and out["mode"] == "tCG"
    staged = tcs.main(base + ["--staged-precision", "--staged-tolresid", "1e-5",
                              "--max-steps", "200"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(staged))
    assert staged["mode"] == "staged_precision" and staged["point"] == "best"
    assert staged["precision"] == "high" and staged["phase2_precision"] == "highest"
    assert len(staged["phase1_residuals"]) == 4 and staged["lanes_above_phase1"] == 0
    assert staged["median_residual"] < staged["phase1_median_residual"]
    with pytest.raises(SystemExit):
        tcs.main(["--problem", "BoundedPCA", "--size", "8", "--batch", "2", "--precision",
                  "high", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcs.main(base + ["--staged-precision", "--solver", "RIPM"])

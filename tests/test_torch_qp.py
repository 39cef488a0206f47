"""The port's lane-batched QP IPM (``riptrm_torch/ops/qp.py``) against
``riptrm_tpu/ops/qp.py``, float64 on the CPU.

Three lanes of random strictly convex QPs (each lane's h shifted
differently, so the lanes need different iteration counts) through every
``method``, with and without equality constraints, cold and with
``warm_z``; each lane's x, z, y, s against the JAX function on that lane
alone to rtol 1e-8 (atol 1e-10), iterations and status equal.  'schulz'
warm-started from the previous QP's ``xinv`` in both packages.  An
indefinite Q freezes its lane with status 2 (as in JAX) and raises
nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riptrm_torch.ops.qp import solve_qp as t_qp
from riptrm_tpu.ops.qp import solve_qp as j_qp

torch.set_num_threads(1)
B, N, M = 3, 8, 10
TOL = dict(abstol=1e-8, reltol=1e-8, feastol=1e-8, maxiter=100)
# The Newton-Schulz inverse stops being usable (status 2) once the barrier
# conditioning explodes; where that happens on the last IPM iteration a
# 1e-15 relative change of h flips JAX's own status, so the schulz cases
# stop one decade earlier.
SCHULZ_TOL = dict(TOL, abstol=1e-6, reltol=1e-6, feastol=1e-6)


def _instance(l, seed=0, indefinite=False):
    rng = np.random.default_rng(seed)
    out = {k: [] for k in "Qpghab"}
    for i in range(B):
        a = rng.standard_normal((N, N))
        q = a @ a.T + 0.5 * np.eye(N)
        if indefinite and i == 1:
            q = -q - 5.0 * np.eye(N)
        out["Q"].append(q)
        out["p"].append(rng.standard_normal(N))
        out["g"].append(rng.standard_normal((M, N)))
        out["h"].append(np.abs(rng.standard_normal(M)) + 0.1 * i)
        out["a"].append(rng.standard_normal((l, N)))
        out["b"].append(0.1 * rng.standard_normal(l))
    return {k: np.array(v) for k, v in out.items()}


def _t(d, **kw):
    T = torch.tensor
    return t_qp(T(d["Q"]), T(d["p"]), T(d["g"]), T(d["h"]), T(d["a"]), T(d["b"]), **kw)


def _j(d, i, **kw):
    return j_qp(d["Q"][i], d["p"][i], d["g"][i], d["h"][i], d["a"][i], d["b"][i], **kw)


def _match(t, j, i):
    assert int(t.iterations[i]) == int(j.iterations)
    assert int(t.status[i]) == int(j.status)
    for name in ("x", "z", "y", "s"):
        np.testing.assert_allclose(getattr(t, name)[i].numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


CASES = [(method, l) for method in ("chol", "lu", "schulz", "schulz_polish") for l in (0, 2)
         if not (l and method.startswith("schulz"))]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_z"])
@pytest.mark.parametrize("method,l", CASES)
def test_lanes_match_jax(method, l, warm):
    d = _instance(l)
    tol = SCHULZ_TOL if method.startswith("schulz") else TOL
    wz = np.abs(np.random.default_rng(5).standard_normal((B, M))) if warm else None
    t = _t(d, method=method, warm_z=None if wz is None else torch.tensor(wz), **tol)
    for i in range(B):
        _match(t, _j(d, i, method=method, warm_z=None if wz is None else wz[i], **tol), i)
    assert int(t.status.max()) == 0


def test_schulz_warm_inverse_matches_jax():
    """The first QP's Newton-Schulz inverse warm-starts a second, nearby
    QP (xinv0), lane by lane as in JAX."""
    d = _instance(0, seed=1)
    t1 = _t(d, method="schulz", **SCHULZ_TOL)
    d2 = dict(d, p=d["p"] + 0.01, h=d["h"] * 1.01)
    t2 = _t(d2, method="schulz", xinv0=t1.xinv, **SCHULZ_TOL)
    for i in range(B):
        j1 = _j(d, i, method="schulz", **SCHULZ_TOL)
        np.testing.assert_allclose(t1.xinv[i].numpy(), np.asarray(j1.xinv), rtol=1e-8,
                                   atol=1e-12)
        j2 = _j(d2, i, method="schulz", xinv0=j1.xinv, **SCHULZ_TOL)
        _match(t2, j2, i)


def test_method_is_never_switched():
    d = _instance(2)
    with pytest.raises(ValueError, match="schulz"):
        _t(d, method="schulz", **TOL)
    with pytest.raises(ValueError, match="method"):
        _t(d, method="cholesky", **TOL)


@pytest.mark.parametrize("method", ["chol", "schulz"])
def test_indefinite_q_freezes_its_lane(method):
    tol = SCHULZ_TOL if method == "schulz" else TOL
    d = _instance(0, seed=2, indefinite=True)
    t = _t(d, method=method, **tol)
    j = _j(d, 1, method=method, **tol)
    assert int(j.status) == 2 and int(t.status[1]) == 2
    assert torch.isfinite(t.x).all()
    # the other lanes are untouched by the frozen one
    for i in (0, 2):
        _match(t, _j(d, i, method=method, **tol), i)

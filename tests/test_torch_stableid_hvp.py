"""StableIdentification's barrier-KKT operator Hw(dx) = Hess L[dx] +
Gx(y * Gxaj(dx) / c) as one ``riptrm::stableid_hvp`` call
(``ops/kernels.py::stableid_barrier_hvp``; on the card the kernel of
``csrc/stableid_hvp.cu``, tested in ``test_torch_cuda.py``), on the CPU at
the shipped instance dataset/StableIdentification/1 with B = 64 lanes
around its start a: the operator's CPU result (its plain version) is the
composition it stands in for, bit for bit, in float32 and float64; the
route (float32 within the plan's limits takes the operator, everything
else the composition); exact mode's materialisation under ``vmap``; the
operator as one node of a traced and of an exported program."""

import collections
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from riptrm_torch.ops import kernels as tk
from riptrm_torch.ops.basis import materialize_symmetrized
from riptrm_torch.problems import stable_identification as si
from riptrm_torch.solvers import riptrm

torch.set_num_threads(1)
DATASET = str(pathlib.Path(__file__).resolve().parents[1] / "dataset/StableIdentification/1")
B = 64
TCG = {"TRS_solver": "tCG", "second_order_stationarity": False}


def _lanes(problem, seed=0):
    """B points around the problem's start, each moved along a random
    tangent (5 % of a unit tangent), multipliers in [0.5, 1.5], mu 0.1 and
    a random direction."""
    dtype = problem.x0.dtype
    g = torch.Generator().manual_seed(seed)
    man = problem.manifold
    x = problem.x0.expand((B,) + problem.x0.shape).clone()
    x = man.retract(x, 0.05 * man.random_tangent(x, g))
    y = torch.rand(B, problem.num_ineq, generator=g, dtype=dtype) + 0.5
    return x, y, torch.full((B,), 0.1, dtype=dtype), man.random_tangent(x, g)


def _shipped(dtype):
    return si.load_problem(DATASET, "a", dtype=dtype, device="cpu")


def _composed(problem, x, y, c):
    """Hw as ``_barrier_ops`` composed it before the operator."""
    lag, gx, gx_adj = problem.lag_rhess_at(x, y), problem.gx_at(x), problem.gx_adj_at(x)
    return lambda dx: lag(dx) + gx((y * gx_adj(dx)) / c)


class _Riptrm(TorchDispatchMode):
    """Records the ``riptrm::`` operators called and their lane counts."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "riptrm":
            self.calls.append((str(func), args[4].shape[0]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_operator_is_the_composition_bit_for_bit(dtype):
    """The operator's CPU implementation gives the composed Hw's values bit
    for bit; in float32 ``_barrier_ops`` returns it."""
    problem = _shipped(dtype)
    x, y, mu, dx = _lanes(problem)
    c = problem.slack(x)
    d = problem.derivatives
    out = torch.ops.riptrm.stableid_hvp(x, d.egrad(x, y)[3], y, c, dx, d.gram, d.idx, d.lin,
                                        d.two, d.p1, d.scale)
    want = _composed(problem, x, y, c)(dx)
    assert torch.isfinite(want).all()
    assert torch.equal(out, want)
    assert torch.equal(riptrm._barrier_ops(problem, x, y, mu)[1](dx), want)


def _wide(d, seed=1):
    """A StableIdentification problem at width d from random data, with the
    generator's constraint mix (48 constraints at d = 9), float32."""
    rng = np.random.default_rng(seed)
    true_a = rng.standard_normal((d, d))
    constset = si.generate_constraints(rng, d, true_a, 0.2, 0.1)
    return si.make_problem(d, [rng.standard_normal((d, 20))], constset,
                           (np.zeros((d, d)), np.eye(d), np.eye(d)), dtype=torch.float32,
                           device="cpu")


def _many_constraints(m):
    """The shipped instance's data at d = 5 with m constraints: a box on
    every entry, then twobox rows on the first m - 50 entries."""
    d = 5
    shipped = _shipped(torch.float64)
    rows = [[0, i // d, i % d, -10.0, 10.0] for i in range(d * d)]
    rows += [[2, i // d, i % d, 0.0, 0.1] for i in range(m - 2 * d * d)]
    trajs = [np.loadtxt(f"{DATASET}/noisyX_{i}.csv") for i in range(1, 6)]
    return si.make_problem(d, trajs, np.asarray(rows), shipped.manifold.unpack(shipped.x0),
                           dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("case", ["f32", "f64", "d_above", "m_above"])
def test_route_by_the_input(case):
    """float32 within the plan's limits (d <= 8, m <= 64) calls the
    operator once a product; float64, d = 9 and m = 65 call no ``riptrm::``
    operator and compose Hw as before, to the same bits."""
    problem = {"f32": lambda: _shipped(torch.float32), "f64": lambda: _shipped(torch.float64),
               "d_above": lambda: _wide(tk.STABLEID_HVP_MAX_D + 1),
               "m_above": lambda: _many_constraints(tk.STABLEID_HVP_MAX_M + 1)}[case]()
    d, m = problem.manifold.manifolds[0].d, problem.num_ineq
    assert (tk.stableid_hvp_plan(d, m) is None) == (case in ("d_above", "m_above"))
    x, y, mu, dx = _lanes(problem)
    c, hw, _ = riptrm._barrier_ops(problem, x, y, mu)
    with _Riptrm() as seen:
        out = hw(dx)
    assert seen.calls == ([("riptrm.stableid_hvp.default", B)] if case == "f32" else [])
    assert torch.equal(out, _composed(problem, x, y, c)(dx))


def test_plan_and_wrapper_limits():
    """The plan at the benchmark's shape (d = 5: 6 lanes a warp, 24 a block)
    and its limits; the wrapper refuses what the plan does not take."""
    assert tk.stableid_hvp_plan(5, 16) == 24
    assert tk.stableid_hvp_plan(8, 64) == 16
    assert tk.stableid_hvp_plan(9, 16) is None and tk.stableid_hvp_plan(5, 65) is None
    problem = _shipped(torch.float64)
    x, y, _, dx = _lanes(problem)
    d = problem.derivatives
    with pytest.raises(ValueError, match="float32"):
        tk.stableid_barrier_hvp(x, d.egrad(x, y)[3], y, problem.slack(x), dx, gram=d.gram,
                                idx=d.idx, lin=d.lin, two=d.two, p1=d.p1, scale=d.scale)


@pytest.mark.parametrize("ms", [False, True], ids=["eigh", "ms"])
def test_exact_materialisation_under_vmap(ms, monkeypatch):
    """Exact mode's payload (``materialize_at``) on float32 lanes: the
    operator under ``vmap`` (its rule folds each basis block's directions
    into the lanes: one call a Product component) gives the composition's
    matrix bit for bit."""
    problem = _shipped(torch.float32)
    x, y, mu, _ = _lanes(problem)
    with _Riptrm() as seen:
        got = riptrm.materialize_at(problem, x, y, mu, ms)
    dims = [m.dim for m in problem.manifold.manifolds]
    assert seen.calls == [("riptrm.stableid_hvp.default", k * B) for k in dims]
    monkeypatch.setattr(si.Derivatives, "barrier_hvp_at", lambda self, x, y, c: None)
    with _Riptrm() as seen:
        want = riptrm.materialize_at(problem, x, y, mu, ms)
    assert seen.calls == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    basis = problem.manifold.basis(x)
    c, hw, _ = riptrm._barrier_ops(problem, x, y, mu)
    assert torch.equal(materialize_symmetrized(problem.manifold, x, basis, hw),
                       materialize_symmetrized(problem.manifold, x, basis,
                                               _composed(problem, x, y, c)))


def _targets(gm):
    counts = collections.Counter()
    for module in gm.modules():
        if isinstance(module, torch.fx.GraphModule):
            counts.update(str(n.target) for n in module.graph.nodes if n.op == "call_function")
    return counts


def test_traced_and_exported_programs_hold_the_operator(tmp_path):
    """``make_fx`` of Hw records one ``riptrm::stableid_hvp`` node and
    nothing else, where the composition records its dozens of products;
    an exported float32 RIPTRM tCG sweep holds it once, in the tCG's loop,
    and runs the direct sweep's values bit for bit."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from riptrm_torch.experiment.export_artifact import export_sweep, load_sweep
    from riptrm_torch.parallel.sweep import batched_riptrm_solve

    problem = _shipped(torch.float32)
    x, y, mu, dx = _lanes(problem)
    c, hw, _ = riptrm._barrier_ops(problem, x, y, mu)
    gm = make_fx(hw, tracing_mode="fake", _allow_non_fake_inputs=True)(dx)
    assert list(_targets(gm).elements()) == ["riptrm.stableid_hvp.default"]
    assert torch.equal(gm(dx), hw(dx))
    composed = make_fx(_composed(problem, x, y, c), tracing_mode="fake",
                       _allow_non_fake_inputs=True)(dx)
    assert _targets(composed)["aten.bmm.default"] >= 10

    lanes, steps = 4, 3
    option = {"maxiter": 30, "tolresid": 1e-6} | TCG
    path = str(tmp_path / "sid.pt2")
    export_sweep(problem, "RIPTRM", option, path, batch=lanes, max_steps=steps, device="cpu")
    targets = _targets(torch.export.load(path).graph_module)
    assert targets["riptrm.stableid_hvp.default"] == 1 and targets["while_loop"] >= 2
    run, _ = load_sweep(path)
    xs, ys = x[:lanes].contiguous(), torch.ones(lanes, problem.num_ineq)
    out = run(xs, ys)
    direct = batched_riptrm_solve(problem, option, steps)(xs, ys)
    assert torch.equal(out[0], direct[0].x) and torch.equal(out[3], direct[2])
    assert torch.isfinite(out[3]).all()

"""The SPD metric's Cholesky solve (``ops/kernels.py::spd_cho_solve``, K9)
on the CPU: its plain version against the library's two triangular solves
(float64 to 1e-12, float32 to a few ulps, each system's error over its
largest |entry|) on a batch, on stacked [B, 2, d, d] systems and on the
narrowed SPD blocks of a packed [B, 3, d, d] tangent; NaN factors; the
route in ``manifolds/spd.py::_cho_solve`` (float32 within the plan to the
operator, everything else to the library bit for bit); the manifolds'
inner products, norms and retractions on both routes; and no solver that
maps a function over basis directions reaching the solve under ``vmap``."""

import pytest
import torch
from torch._C._functorch import is_batchedtensor
from torch.utils._python_dispatch import TorchDispatchMode

from riptrm_torch.manifolds import Euclidean, Product, SkewSymmetric, spd
from riptrm_torch.ops import kernels as tk

torch.set_num_threads(1)
B = 64
# float32: the plain version and the library part by a few roundings of
# well-conditioned systems (3.2 ulps of the largest entry read at d = 8)
F32_ULPS = 8


def _library(l, u):
    """The two triangular solves ``_cho_solve`` takes outside the plan."""
    a = torch.linalg.solve_triangular(l, u, upper=False)
    return torch.linalg.solve_triangular(l.transpose(-2, -1), a, upper=True)


def _systems(d, layout, dtype, seed=0):
    """(factor, right-hand sides) of B systems of width d: ``lanes`` [B, d,
    d], ``stacked`` [B, 2, d, d], ``narrowed`` the SPD blocks of a packed
    [B, 3, d, d] tangent as Product passes them.  The points are
    ``random_point``'s (eigenvalues in [1, 2]); the factor is ``_chol``'s."""
    g = torch.Generator().manual_seed(seed)
    lead = {"lanes": (B,), "stacked": (B, 2), "narrowed": (B, 2)}[layout]
    count = B * (2 if len(lead) == 2 else 1)
    x = spd.SymmetricPositiveDefinite(d).random_point(g, count, dtype=dtype, device="cpu")
    v = torch.randn((B, 3, d, d) if layout == "narrowed" else lead + (d, d), generator=g,
                    dtype=dtype)
    u = v + v.mT
    return spd._chol(x.reshape(lead + (d, d))), u.narrow(1, 1, 2) if layout == "narrowed" else u


def _system_error(a, b):
    """Each system's largest |a - b| over its largest |b|."""
    def top(t):
        return t.abs().flatten(-2).amax(dim=-1)

    return top(a - b) / top(b)


@pytest.mark.parametrize("layout", ["lanes", "stacked", "narrowed"])
@pytest.mark.parametrize("d", [1, 2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_matches_library(dtype, d, layout):
    l, u = _systems(d, layout, dtype, seed=d)
    plain = tk.spd_cho_solve_plain(l, u)
    assert plain.shape == u.shape and plain.is_contiguous()
    limit = 1e-12 if dtype == torch.float64 else F32_ULPS * torch.finfo(dtype).eps
    assert float(_system_error(plain, _library(l, u)).max()) <= limit


def test_operator_reads_views_in_place():
    """The operator on the narrowed view and the column-major factor gives
    the bits it gives on contiguous copies (the CPU runs the plain
    version)."""
    l, u = _systems(5, "narrowed", torch.float32)
    assert not u.is_contiguous() and not l.is_contiguous()
    assert torch.equal(tk.spd_cho_solve(l, u), tk.spd_cho_solve(l.contiguous(), u.contiguous()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_nan_factor_reads_nan(dtype):
    """A system whose point is not positive definite (``_chol`` writes NaN
    over its factor) comes out NaN whole; the other systems are unchanged."""
    g = torch.Generator().manual_seed(1)
    x = spd.SymmetricPositiveDefinite(5).random_point(g, 2 * B, dtype=dtype, device="cpu")
    x = x.reshape(B, 2, 5, 5)
    u = torch.randn(B, 3, 5, 5, generator=g, dtype=dtype).narrow(1, 1, 2)
    ok = tk.spd_cho_solve_plain(spd._chol(x), u)
    x = x.clone()
    x[3, 1] = -x[3, 1]
    out = tk.spd_cho_solve_plain(spd._chol(x), u)
    rest = torch.ones(B, 2, dtype=torch.bool)
    rest[3, 1] = False
    assert torch.isnan(out[3, 1]).all() and torch.equal(out[rest], ok[rest])
    assert torch.isnan(spd._cho_solve(spd._chol(x), u)[3, 1]).all()


def _captured(fn):
    """(``fn()``, the names of the operators it dispatched)."""
    seen = []

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), k=None):
            seen.append(str(func.overloadpacket))
            return func(*a, **(k or {}))

    with Capture():
        out = fn()
    return out, seen


@pytest.mark.parametrize("case", ["f32", "f64", "f32-d9", "f32-broadcast"])
def test_route(case):
    """float32 systems of one shape within the plan go to the operator, and
    to nothing else; float64, a width above the plan and a right-hand side
    broadcast against the factor keep the library's two triangular solves,
    bit for bit the values of the code before the kernel."""
    dtype = torch.float64 if case == "f64" else torch.float32
    d = 9 if case == "f32-d9" else 5
    l, u = _systems(d, "narrowed", dtype)
    if case == "f32-broadcast":
        u = u[:1, :1]
    out, seen = _captured(lambda: spd._cho_solve(l, u))
    if case == "f32":
        assert seen == ["riptrm.spd_cho_solve"]
        assert torch.equal(out, tk.spd_cho_solve_plain(l, u))
    else:
        assert "riptrm.spd_cho_solve" not in seen and "aten.linalg_solve_triangular" in seen
        assert torch.equal(out, _library(l, u))


def test_plan_and_wrapper_limits():
    assert [tk.spd_solve_plan(d) for d in (0, 1, 5, 8, 9)] == [None, 256, 51, 32, None]
    l, u = _systems(5, "stacked", torch.float32)
    wide = torch.eye(9).expand(B, 9, 9)
    for bad in ((l.double(), u.double()), (l, u[:, :1]), (wide, wide)):
        with pytest.raises(ValueError, match="spd_cho_solve"):
            tk.spd_cho_solve(*bad)


def _sid_product():
    return Product((SkewSymmetric(5), spd.SymmetricPositiveDefinite(5),
                    spd.SymmetricPositiveDefinite(5)))


@pytest.mark.parametrize("man", ["spd", "product", "product-mixed"])
def test_manifold_operators_agree_with_the_library(man, monkeypatch):
    """SPD's and Product's ``inner``, ``inner_at``, ``norm`` and ``retract``
    in float32 through the kernel's route and through the library's (the
    plan patched to take nothing) agree to float32 rounding."""
    g = torch.Generator().manual_seed(2)
    m = {"spd": spd.SymmetricPositiveDefinite(5), "product": _sid_product(),
         "product-mixed": Product((Euclidean(3), spd.SymmetricPositiveDefinite(4)))}[man]
    x = m.random_point(g, B, dtype=torch.float32, device="cpu")
    u, v = m.random_tangent(x, g), m.random_tangent(x, g)

    def ops():
        inner = m.inner_at(x)
        return (m.inner(x, u, v), inner(u, v), inner(u, u), m.norm(x, u),
                m.retract(x, 0.1 * u))

    kernel, seen = _captured(ops)
    assert "riptrm.spd_cho_solve" in seen
    monkeypatch.setattr(tk, "spd_solve_plan", lambda d: None)
    library, seen = _captured(ops)
    assert "riptrm.spd_cho_solve" not in seen
    for a, b in zip(kernel, library):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_every_triangular_solve_of_the_cell_step_is_the_metric(monkeypatch):
    """On StableIdentification's RIPTRM tCG sweep (the benchmark cell's
    options, float64: the library's route) every
    ``torch.linalg.solve_triangular`` call comes from ``spd.py``, two a
    Cholesky solve and two a congruence (``dist``'s, twice a step in the
    evaluation); in float32 each Cholesky solve is one operator call and
    only the congruences take the library's solves."""
    from riptrm_torch.parallel.sweep import batched_riptrm_solve
    from riptrm_torch.problems import stable_identification as si

    option = {"maxiter": 60, "tolresid": 1e-3, "TRS_solver": "tCG",
              "second_order_stationarity": False}
    counts = dict.fromkeys(("solve_triangular", "cho", "congruence", "kernel"), 0)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.linalg, "solve_triangular",
                        counting("solve_triangular", torch.linalg.solve_triangular))
    monkeypatch.setattr(spd, "_cho_solve", counting("cho", spd._cho_solve))
    monkeypatch.setattr(spd, "_congruence_inv", counting("congruence", spd._congruence_inv))
    monkeypatch.setattr(tk, "spd_cho_solve", counting("kernel", tk.spd_cho_solve))
    for dtype in (torch.float64, torch.float32):
        problems = [si.load_problem("dataset/StableIdentification/1", s, dtype=dtype,
                                    device="cpu") for s in "abcd"]
        xs = torch.stack([p.x0 for p in problems])
        ys = torch.ones(4, problems[0].num_ineq, dtype=dtype)
        counts.update(dict.fromkeys(counts, 0))
        _, k, res = batched_riptrm_solve(problems[0], option, 3)(xs, ys)
        assert int(k.max()) == 3 and torch.isfinite(res).all()
        assert counts["cho"] > 0
        if dtype == torch.float64:
            assert counts["kernel"] == 0
            assert counts["solve_triangular"] == 2 * (counts["cho"] + counts["congruence"])
        else:
            assert counts["solve_triangular"] == 2 * counts["congruence"] == 4 * int(k.max())
            assert counts["kernel"] == counts["cho"]


@pytest.mark.parametrize("solver,option", [
    ("RIPTRM", {"maxiter": 3, "tolresid": 1e-6}),
    ("RIPM", {"maxiter": 3, "tolresid": 1e-6}),
    ("RSQO", {"maxiter": 3, "tolresid": 1e-6}),
], ids=["riptrm-exact", "ripm", "rsqo"])
def test_no_solver_maps_over_the_solve(solver, option, monkeypatch):
    """Exact mode, RIPM and RSQO map functions over basis directions with
    ``torch.func.vmap``; on StableIdentification in float32 none of them
    reaches the metric's solve under it (the operator needs no vmap rule),
    while each solves through it."""
    from riptrm_torch.parallel.sweep import batched_solver_sweep
    from riptrm_torch.problems import stable_identification as si

    seen = {"calls": 0, "batched": 0}
    cho_solve = spd._cho_solve

    def probe(l, u):
        seen["calls"] += 1
        seen["batched"] += is_batchedtensor(l) or is_batchedtensor(u)
        return cho_solve(l, u)

    monkeypatch.setattr(spd, "_cho_solve", probe)
    problems = [si.load_problem("dataset/StableIdentification/1", s, dtype=torch.float32,
                                device="cpu") for s in "ab"]
    xs = torch.stack([p.x0 for p in problems])
    _, _, k, res = batched_solver_sweep(problems[0], solver, option, 2)(
        xs, torch.ones(2, problems[0].num_ineq))
    assert int(k.max()) == 2 and torch.isfinite(res).all()
    assert seen["calls"] > 0 and seen["batched"] == 0

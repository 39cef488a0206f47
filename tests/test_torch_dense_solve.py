"""The dense Newton solve (``riptrm_torch/ops/kernels.py::dense_solve_nan``)
on the CPU: its plain version (the kernel's algorithm: unblocked LU with
partial pivoting, ties to the lowest position, NaN on a zero pivot)
against ``torch.linalg.solve``, its NaN and tie rules, lane independence,
the plan's routes, the operator under ``torch.export`` and RIPM's calls.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``
holds it to this plain version there.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from riptrm_torch.ops import kernels as tk

torch.set_num_threads(1)
SIZES = sorted({1, 2, 12, 49, 64, tk.DENSE_SOLVE_MAX_N})
KINDS = ("general", "symmetric", "saddle")


def _system(kind, n, lanes, dtype, seed=0):
    """``lanes`` systems of size n: a general matrix, a symmetric indefinite
    one, or a saddle [[H, G'], [G, 0]] with a zero block of n // 4 rows."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((lanes, n, n)) / np.sqrt(n)
    if kind == "general":
        a = a + np.eye(n)
    elif kind == "symmetric":
        q = np.linalg.qr(rng.standard_normal((lanes, n, n)))[0]
        d = rng.uniform(0.5, 2.0, (lanes, n)) * np.where(np.arange(n) % 2, -1.0, 1.0)
        a = q @ (d[:, :, None] * q.transpose(0, 2, 1))
    else:
        l = n // 4
        h = a[:, : n - l, : n - l]
        a = np.zeros((lanes, n, n))
        a[:, : n - l, : n - l] = h + h.transpose(0, 2, 1)
        g = rng.standard_normal((lanes, l, n - l))
        a[:, n - l:, : n - l] = g
        a[:, : n - l, n - l:] = g.transpose(0, 2, 1)
    b = rng.standard_normal((lanes, n))
    return torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype)


def _rel(x, ref):
    return (torch.linalg.vector_norm(x - ref, dim=-1)
            / torch.linalg.vector_norm(ref, dim=-1)).double()


class _Ops(TorchDispatchMode):
    """Counts the operators of the ``riptrm`` namespace a call reaches."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "riptrm":
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind,n", [(k, n) for k in KINDS for n in SIZES
                                    if k != "saddle" or n >= 4])
@pytest.mark.parametrize("lanes", [1, 6])
def test_plain_matches_library(dtype, kind, n, lanes):
    """The plain version agrees with torch.linalg.solve to the backward-stable
    bound (a few n eps cond), lane by lane, on general, symmetric indefinite
    and saddle (zero-block) systems; the wrapper gives the plain version on
    the CPU in float32 and the library's solve in float64."""
    a, b = _system(kind, n, lanes, dtype, seed=n)
    x = tk.dense_solve_plain(a, b)
    ref = torch.linalg.solve(a, b)
    assert x.dtype == dtype and x.shape == (lanes, n)
    cond = torch.linalg.cond(a.double())
    bound = 4 * n * torch.finfo(dtype).eps * cond
    assert torch.all(_rel(x, ref) <= bound), (_rel(x, ref), bound)
    out = tk.dense_solve_nan(a, b)
    assert torch.equal(out, x if dtype == torch.float32 else ref)


@pytest.mark.parametrize("route", ["plain", "library"])
def test_zero_pivot_lane_reads_nan(route):
    """A lane whose LU meets an exact zero pivot (two equal rows) reads NaN
    whole; its neighbours read what they read alone."""
    dtype = torch.float32 if route == "plain" else torch.float64
    a, b = _system("general", 12, 3, dtype, seed=3)
    a[1, 7] = a[1, 2]
    x = tk.dense_solve_nan(a, b)
    assert torch.isnan(x[1]).all()
    for i in (0, 2):
        alone = tk.dense_solve_nan(a[i:i + 1], b[i:i + 1])[0]
        assert torch.isfinite(x[i]).all() and torch.equal(x[i], alone)


def test_non_finite_input_reads_nan():
    """A NaN in a matrix or an inf in a right-hand side: that lane reads NaN
    whole, the others are untouched."""
    a, b = _system("general", 49, 4, torch.float32, seed=4)
    clean = tk.dense_solve_plain(a, b)
    a[1, 10, 30] = float("nan")
    b[2, 5] = float("inf")
    x = tk.dense_solve_plain(a, b)
    assert torch.isnan(x[1]).all() and torch.isnan(x[2]).all()
    assert torch.equal(x[0], clean[0]) and torch.equal(x[3], clean[3])


def tie_systems():
    """(a, b, x, x with the other choice) float32: systems with a tie in a
    pivot column whose answer tells the two choices apart by a rounding.
    [[1, 1], [-1, 2]] x = [1, 0]: row 0 pivots, x0 = fl(1 - fl(1/3)); row 1
    would give 2 fl(1/3).  Rows [0, -1, 1], [0, 1, 2], [2, 0, 0]: row 2
    pivots first and row 0 moves to position 2, so at step 1 row 1
    (position 1) ties with row 0 (position 2) and wins, x1 = -2 fl(1/3);
    row 0, the lower original index, would give fl(fl(1/3) - 1)."""
    third = torch.tensor(1.0) / 3
    two = torch.tensor(2.0)
    return [
        (torch.tensor([[[1.0, 1.0], [-1.0, 2.0]]]), torch.tensor([[1.0, 0.0]]),
         torch.stack([1 - third, third])[None], torch.stack([2 * third, third])[None]),
        (torch.tensor([[[0.0, -1.0, 1.0], [0.0, 1.0, 2.0], [2.0, 0.0, 0.0]]]),
         torch.tensor([[1.0, 0.0, 4.0]]), torch.stack([two, -2 * third, third])[None],
         torch.stack([two, third - 1, third])[None]),
    ]


def test_tie_takes_the_lower_row():
    """Equal |a_ik|: the pivot is the lowest position in the swapped order,
    LAPACK's choice, and the answer shows it."""
    for a, b, want, other in tie_systems():
        assert not torch.equal(want, other)
        assert torch.equal(tk.dense_solve_nan(a, b), want)
        assert torch.allclose(torch.linalg.solve(a.double(), b.double()).float(), want)


@pytest.mark.parametrize("n", [4, 6])
def test_pivots_are_lapacks(n):
    """On matrices of +-1 entries (ties everywhere, small exact pivots) the
    pivot rows and U equal LAPACK's getrf on every nonsingular lane."""
    g = torch.Generator().manual_seed(n)
    a = (torch.randint(0, 2, (2000, n, n), generator=g) * 2 - 1).double()
    lu, ipiv, info = torch.linalg.lu_factor_ex(a)
    u, _, piv, singular = tk.dense_lu_plain(a, torch.ones(2000, n, dtype=torch.float64))
    ok = ~singular & (info == 0)
    assert ok.sum() > 500
    assert torch.equal(piv[ok], ipiv[ok].long() - 1)
    assert torch.equal(u[ok].triu(), lu[ok].triu())


def test_lane_alone_equals_lane_in_batch():
    """A lane's answer does not depend on the batch around it."""
    a, b = _system("symmetric", 49, 9, torch.float32, seed=5)
    x = tk.dense_solve_plain(a, b)
    for i in (0, 4, 8):
        assert torch.equal(tk.dense_solve_plain(a[i:i + 1], b[i:i + 1])[0], x[i])
    perm = torch.tensor([8, 3, 0, 5, 1, 7, 2, 6, 4])
    assert torch.equal(tk.dense_solve_plain(a[perm], b[perm]), x[perm])


def test_plan():
    """One or two rows a thread, a block of DENSE_SOLVE_WARPS systems, the
    shared memory of ``csrc/dense_solve.cu::warp_floats``; no plan above
    the limit."""
    assert tk.DENSE_SOLVE_MAX_N >= 64
    assert tk.dense_solve_plan(1, 1) == tk.DenseSolvePlan(1, 1, 4 * 4 * (1 + 1))
    assert tk.dense_solve_plan(32, 5) == tk.DenseSolvePlan(1, 2, 4 * 4 * (32 * 33 + 32))
    assert tk.dense_solve_plan(49, 131072) == tk.DenseSolvePlan(2, 32768,
                                                                4 * 4 * (49 * 49 + 49))
    assert tk.dense_solve_plan(tk.DENSE_SOLVE_MAX_N, 3).rows == 2
    assert tk.dense_solve_plan(tk.DENSE_SOLVE_MAX_N, 3).smem <= tk.MAX_SMEM_BYTES
    assert tk.dense_solve_plan(tk.DENSE_SOLVE_MAX_N + 1, 3) is None
    assert tk.dense_solve_plan(0, 3) is None


@pytest.mark.parametrize("dtype,n,operator", [
    (torch.float32, 12, True),
    (torch.float32, tk.DENSE_SOLVE_MAX_N, True),
    (torch.float32, tk.DENSE_SOLVE_MAX_N + 1, False),
    (torch.float64, 12, False),
], ids=["f32-12", "f32-limit", "f32-above", "f64"])
def test_routes(dtype, n, operator):
    """float32 up to the limit takes riptrm::dense_solve; float64 (never cast
    down) and n above the limit take the library's solve.  On the CPU no
    launch is counted either way."""
    a, b = _system("general", n, 3, dtype, seed=6)
    tk.reset_launch_counts()
    with _Ops() as ops:
        x = tk.dense_solve_nan(a, b)
    assert ops.seen == (["riptrm.dense_solve.default"] if operator else [])
    assert x.dtype == dtype
    if not operator:
        assert torch.equal(x, torch.linalg.solve(a, b))
    assert tk.launch_counts()["dense_solve_nan"] == 0


def test_any_layout():
    """A column-major batch (as RIPM's symmetrised materialisation leaves
    it) reads the row-major batch's answer."""
    a, b = _system("general", 12, 4, torch.float32, seed=9)
    cm = a.mT.contiguous().mT
    assert not cm.is_contiguous()
    assert torch.equal(tk.dense_solve_nan(cm, b), tk.dense_solve_nan(a, b))


def test_refuses_other_shapes():
    a, b = _system("general", 5, 2, torch.float32)
    for bad in ((a[0], b[0]), (a, b[:, :4]), (a, b.double()), (a[:, :, :4], b)):
        with pytest.raises(ValueError, match="dense_solve_nan"):
            tk.dense_solve_nan(*bad)


def test_export_holds_the_operator():
    """torch.export records riptrm::dense_solve as one node with the fake
    implementation's shape, and the exported program gives the eager
    answer."""

    class Solve(torch.nn.Module):
        def forward(self, a, b):
            return tk.dense_solve_nan(a, b)

    a, b = _system("saddle", 12, 5, torch.float32, seed=7)
    ep = torch.export.export(Solve(), (a, b))
    nodes = [n for n in ep.graph.nodes if str(n.target) == "riptrm.dense_solve.default"]
    assert len(nodes) == 1
    val = nodes[0].meta["val"]
    assert tuple(val.shape) == (5, 12) and val.dtype == torch.float32
    assert torch.equal(ep.module()(a, b), tk.dense_solve_nan(a, b))


@pytest.mark.parametrize("dtype,calls", [(torch.float32, True), (torch.float64, False)],
                         ids=["f32", "f64"])
def test_ripm_dense_step_calls_the_operator(dtype, calls):
    """RIPM's dense Newton solve reaches riptrm::dense_solve once a step in
    float32 (N = n - 1 on the sphere) and never in float64."""
    from riptrm_torch.parallel.sweep import batched_solver_sweep
    from riptrm_torch.problems import nonneg_pca

    rng = np.random.default_rng(8)
    n, lanes, steps = 10, 3, 4
    z = rng.standard_normal((n, n))
    z = z @ z.T / n
    xs = np.abs(rng.standard_normal((lanes, n)))
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    problem = nonneg_pca.make_problem(torch.tensor(z), torch.tensor(xs[0]), dtype=dtype,
                                      device="cpu")
    sweep = batched_solver_sweep(problem, "RIPM", {"maxiter": steps, "tolresid": 0.0}, steps)
    with _Ops() as ops:
        x, _, ks, res = sweep(torch.tensor(xs, dtype=dtype), torch.ones(lanes, n, dtype=dtype))
    assert len(ops.seen) == (int(ks.max()) if calls else 0)
    assert int(ks.max()) > 0 and torch.isfinite(res).all()

"""Stable LTI system identification on Product(SkewSymmetric, SPD, SPD).

Counterpart of ``riptrm_tpu/problems/stable_identification.py``.  A point
is (J, R, Q), packed [3, d, d] per lane (``manifolds/product.py``);
A = (J - R) Q is stable for every point, and the cost is the one-step
prediction error over the concatenated trajectories.  The heterogeneous
constraint list (onebox pairs and twobox quadratics) is one stacked
function over per-constraint kind/row/column/parameter arrays gathered
from A, in the reference's append order, so multipliers line up with the
JAX package's.

The numpy parts of the generators (``parse_constset``,
``generate_constraints``, ``generate_trajectory``,
``feasible_entry_targets``) are the JAX package's, line for line, and
give its results from the same ``np.random.default_rng`` seed; the draws
the JAX package takes from ``jax.random`` come here from a
``torch.Generator``.  ``generate_interior_initialpoint_lsq`` runs all its
starts as lanes of one lane-masked conjugate gradient.

``matmul_precision`` ('high': TF32 on CUDA; 'highest': full float32) is
scoped to the problem's own operators (``problems/problem.py``).
``mesh``/``data_axis`` split the trajectory data's columns across the ranks
of a mesh axis, the cost the sum of the ranks' partial sums
(``ops/collectives.py``'s ``enter`` and ``exit_sum``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.func import grad, vmap

from riptrm_torch.config import as_tensor, check_matmul_precision, resolve
from riptrm_torch.manifolds import Product, SkewSymmetric, SymmetricPositiveDefinite
from riptrm_torch.manifolds.base import bmm
from riptrm_torch.ops import kernels
from riptrm_torch.ops.collectives import enter, exit_sum, mesh_axis
from riptrm_torch.problems.problem import Problem
from riptrm_torch.utils.io import loadtxt

KIND_LS = 0  # -A[r,c] + p1 <= 0
KIND_RS = 1  # A[r,c] - p2 <= 0
KIND_TWO = 2  # -(A[r,c] - p1)^2 + p2^2 <= 0


def manifold(d: int) -> Product:
    """Product(SkewSymmetric(d), SPD(d), SPD(d)), points [B, 3, d, d]."""
    return Product([SkewSymmetric(d), SymmetricPositiveDefinite(d),
                    SymmetricPositiveDefinite(d)])


def parse_constset(constset, interior_scaling: float = 1.0):
    """Expand constset rows into per-constraint arrays, preserving the
    reference's append order (``coordinator.py:132-152``).

    Each constset row: [type, row, col, p3, p4, (Aval)].
    type 0/1 -> onebox pair (ls then rs); type 2 -> twobox single.
    ``interior_scaling`` reproduces the generator's tightened constraints
    (``generator.py:274-292``).
    """
    constset = np.atleast_2d(np.asarray(constset))
    kinds, rows, cols, p1s, p2s = [], [], [], [], []
    for row in constset:
        t = int(row[0])
        r, c = int(row[1]), int(row[2])
        if t in (0, 1):
            ls = row[3] * interior_scaling
            rs = row[4] * interior_scaling
            kinds += [KIND_LS, KIND_RS]
            rows += [r, r]
            cols += [c, c]
            p1s += [ls, 0.0]
            p2s += [0.0, rs]
        elif t == 2:
            cc = row[3]
            k = row[4] * (1.0 + (1.0 - interior_scaling))
            kinds.append(KIND_TWO)
            rows.append(r)
            cols.append(c)
            p1s.append(cc)
            p2s.append(k)
        else:
            raise ValueError(f"Invalid constraint type {t}")
    return (
        np.asarray(kinds, dtype=np.int32),
        np.asarray(rows, dtype=np.int32),
        np.asarray(cols, dtype=np.int32),
        np.asarray(p1s),
        np.asarray(p2s),
    )


def _split_xxp(x_full):
    return x_full[:, :-1], x_full[:, 1:]


def _entries(a, idx):
    """The constrained entries of A [B, d, d], [B, m]."""
    return a.flatten(-2)[..., idx]


def _scatter(w, onehot, d):
    """[B, m] constraint weights onto their entries, [B, d, d]: a one-hot
    [m, d*d] product (a repeated entry sums in a fixed order)."""
    return (w @ onehot).unflatten(-1, (d, d))


def _frozen(x, idx, lin, two, p1):
    """The point's work: (J - R, Q, A, the constraints' slopes g_i')."""
    jmr, q = x[:, 0] - x[:, 1], x[:, 2]
    a = bmm(jmr, q)
    slope = lin - 2.0 * two * (_entries(a, idx) - p1)
    return jmr, q, a, slope


def _d_a(jmr, q, v):
    return bmm(v[:, 0] - v[:, 1], q) + bmm(jmr, v[:, 2])


def _in_jrq(jmr, q, g):
    """A Euclidean gradient in A, [B, d, d], as one in (J, R, Q)."""
    gq = bmm(g, q.transpose(-2, -1))
    return torch.stack((gq, -gq, bmm(jmr.transpose(-2, -1), g)), dim=1)


def _lag_ehvp(jmr, q, g, curv, scale, gram, idx, onehot, v):
    """The Euclidean Hessian image of the Lagrangian along v (``Derivatives``)."""
    d = jmr.shape[-1]
    da = _d_a(jmr, q, v)
    dg = scale * (da @ gram) + _scatter(curv * _entries(da, idx), onehot, d)
    dgq = bmm(dg, q.transpose(-2, -1)) + bmm(g, v[:, 2].transpose(-2, -1))
    dq = bmm((v[:, 0] - v[:, 1]).transpose(-2, -1), g) + bmm(jmr.transpose(-2, -1), dg)
    return torch.stack((dgq, -dgq, dq), dim=1)


def _ineq_jvp(jmr, q, slope, idx, dx):
    return slope * _entries(_d_a(jmr, q, dx), idx)


def _ineq_vjp(jmr, q, slope, onehot, w):
    return _in_jrq(jmr, q, _scatter(w * slope, onehot, jmr.shape[-1]))


def barrier_hvp_plain(x, g, y, c, dx, gram, idx, lin, two, p1, scale):
    """The barrier-KKT operator Hw(dx) = Hess L[dx] + Gx(y * Gxaj(dx) / c)
    at (x, y) as ``solvers/riptrm.py::_barrier_ops`` composes it from
    ``Problem.lag_rhess_at``, ``gx_at`` and ``gx_adj_at`` over the closed
    form: the same operators in the same order, so the same values bit for
    bit.  ``g`` is the Lagrangian's Euclidean gradient in A
    (``Derivatives.egrad``), ``c`` the slacks, ``gram`` X X', ``idx`` the
    constrained entries (row * d + column), ``lin``, ``two``, ``p1`` the
    constraints' kinds and parameters, ``scale`` 2 h^2 / N.  The plain
    version of ``riptrm::stableid_hvp`` (``ops/kernels.py``)."""
    d = x.shape[-1]
    man = manifold(d)
    onehot = torch.nn.functional.one_hot(idx, d * d).to(x.dtype)
    jmr, q, _, slope = _frozen(x, idx, lin, two, p1)
    curv = (-2.0 * two) * y
    eh = _lag_ehvp(jmr, q, g, curv, scale, gram, idx, onehot, dx)
    lag = man.ehess2rhess(x, _in_jrq(jmr, q, g), eh, dx)
    w = (y * -_ineq_jvp(jmr, q, slope, idx, dx)) / c
    return lag + man.egrad2rgrad(x, _ineq_vjp(jmr, q, slope, onehot, -w))


class Derivatives:
    """The Lagrangian's derivatives in closed form, over lanes: the
    derivatives the upstream takes by autograd (and ``Problem`` by
    torch.func), as a few dozen batched operators.

    With A = (J - R) Q, the cost f = ||XP - (I + hA) X||^2 / N and the
    constraints g_i(a_i), a_i = A[r_i, c_i], the Euclidean gradient of
    L = f + y . g in A is G = -(2h/N) (XP - (I + hA) X) X' plus y_i g_i'
    at each (r_i, c_i); in (J, R, Q) it is (G Q', -G Q', (J - R)' G).
    Along v = (vJ, vR, vQ), dA = (vJ - vR) Q + (J - R) vQ, and
    dG = (2h^2/N) dA X X' plus y_i g_i'' dA[r_i, c_i], so the Hessian
    image is (dG Q' + G vQ', -(dG Q' + G vQ'), (vJ - vR)' G + (J - R)' dG).
    g' is -1 (``KIND_LS``), +1 (``KIND_RS``) or -2 (a - p1) (``KIND_TWO``,
    whose g'' is -2).  Constraint values reach their entries of A through
    a one-hot [m, d*d] product (a repeated entry sums in a fixed order).

    ``barrier_hvp_at`` gives the barrier-KKT operator whole, as one
    ``riptrm::stableid_hvp`` call a product (``ops/kernels.py``), where
    that operator's plan takes the point."""

    def __init__(self, X, XP, n_cols, h, kinds, rows, cols, p1, gram):
        d = X.shape[0]
        self.X, self.XP, self.n_cols, self.h, self.d = X, XP, n_cols, h, d
        self.eye = torch.eye(d, dtype=X.dtype, device=X.device)
        self.idx = rows * d + cols
        self.onehot = torch.nn.functional.one_hot(self.idx, d * d).to(X.dtype)
        self.lin = torch.where(kinds == KIND_LS, -1.0, torch.where(kinds == KIND_RS, 1.0, 0.0)
                               ).to(X.dtype)
        self.two = (kinds == KIND_TWO).to(X.dtype)
        self.p1, self.gram = p1, gram
        self.scale = 2.0 * h**2 / n_cols

    def _frozen(self, x):
        return _frozen(x, self.idx, self.lin, self.two, self.p1)

    def egrad(self, x, y):
        """(J - R, Q, the slopes, the Lagrangian's Euclidean gradient G in A)."""
        jmr, q, a, slope = self._frozen(x)
        resid = self.XP - (self.eye + self.h * a) @ self.X
        g = ((-2.0 * self.h / self.n_cols) * (resid @ self.X.mT)
             + _scatter(y * slope, self.onehot, self.d))
        return jmr, q, slope, g

    def lag_at(self, x, y):
        jmr, q, _, g = self.egrad(x, y)
        curv = (-2.0 * self.two) * y
        return _in_jrq(jmr, q, g), functools.partial(
            _lag_ehvp, jmr, q, g, curv, self.scale, self.gram, self.idx, self.onehot)

    def ineq_at(self, x):
        jmr, q, _, slope = self._frozen(x)
        return (functools.partial(_ineq_jvp, jmr, q, slope, self.idx),
                functools.partial(_ineq_vjp, jmr, q, slope, self.onehot))

    def barrier_hvp_at(self, x, y, c):
        """dx -> Hw(dx), the barrier-KKT operator at (x, y) with slacks c,
        as one ``ops/kernels.py::stableid_barrier_hvp`` call a product, its
        point's work (G) done here once; None where the operator's plan
        takes no such point (float64, d or m above its limits): the caller
        then composes Hw from ``lag_at`` and ``ineq_at``."""
        if x.dtype != torch.float32 or kernels.stableid_hvp_plan(
                self.d, self.idx.shape[0]) is None:
            return None
        g = self.egrad(x, y)[3]
        return functools.partial(kernels.stableid_barrier_hvp, x, g, y, c, gram=self.gram,
                                 idx=self.idx, lin=self.lin, two=self.two, p1=self.p1,
                                 scale=self.scale)


def make_problem(
    d: int,
    x_trajs,  # list of [d, N] trajectory arrays
    constset,
    x0,  # (J, R, Q)
    y0=None,
    h: float = 0.02,
    interior_scaling: float = 1.0,
    cost_zero: bool = False,
    dtype=None,
    device=None,
    mesh=None,
    data_axis: str = "tp",
    matmul_precision=None,
) -> Problem:
    """Build the StableIdentification problem; ``x0`` is the (J, R, Q)
    triple (numpy arrays or tensors), packed into ``problem.x0`` [3, d, d].

    ``mesh``/``data_axis``: each rank of the axis holds [d, N/size] columns
    of X and XP (zero-padded to a multiple of the size: a zero (x, x')
    column pair adds 0 to the residual sum, and the cost still divides by
    the true N).  Every cost, gradient and Hessian-vector evaluation
    contracts the rank's own columns and sums the partial sums across the
    axis; the point (J, R, Q) and the constraints stay replicated.  The
    data is not collapsed to d x d Gram matrices: that is another
    algorithm, with other rounding."""
    check_matmul_precision(matmul_precision)
    if not x_trajs and not cost_zero:
        raise ValueError(
            "make_problem got no trajectories with cost_zero=False: the "
            "least-squares cost would be 0/0 = NaN; pass cost_zero=True for "
            "pure feasibility problems"
        )
    dtype, device = resolve(dtype, device)
    man = manifold(d)
    xs, xps = [], []
    for xt in x_trajs:
        a, b = _split_xxp(np.asarray(xt))
        xs.append(a)
        xps.append(b)
    X = torch.tensor(np.hstack(xs) if xs else np.zeros((d, 0)), dtype=dtype, device=device)
    XP = torch.tensor(np.hstack(xps) if xps else np.zeros((d, 0)), dtype=dtype,
                      device=device)
    n_cols = X.shape[1]
    group = None
    if mesh is not None and n_cols:
        group, size, index = mesh_axis(mesh, data_axis)
        pad = (-n_cols) % size
        mine = slice(index * (n_cols + pad) // size, (index + 1) * (n_cols + pad) // size)
        X, XP = (torch.nn.functional.pad(a, (0, pad))[:, mine].contiguous() for a in (X, XP))

    kinds, rows, cols, p1s, p2s = parse_constset(constset, interior_scaling)
    kinds_t = torch.tensor(kinds, device=device)
    rows_t = torch.tensor(rows, dtype=torch.int64, device=device)
    cols_t = torch.tensor(cols, dtype=torch.int64, device=device)
    p1_t = torch.tensor(p1s, dtype=dtype, device=device)
    p2_t = torch.tensor(p2s, dtype=dtype, device=device)
    m = len(kinds)
    eye = torch.eye(d, dtype=dtype, device=device)
    derivatives = None
    if group is None and not cost_zero:
        # X X' from the float64 data, rounded once
        gram = torch.tensor(np.hstack(xs) @ np.hstack(xs).T, dtype=dtype, device=device)
        derivatives = Derivatives(X, XP, n_cols, h, kinds_t, rows_t, cols_t, p1_t, gram)

    def cost_fn(x):
        J, R, Q = x[0], x[1], x[2]
        if cost_zero:
            # the feasibility problem of the initial-point generator; a tiny
            # quadratic keeps the gradient defined
            return 0.0 * torch.sum(J**2)
        A = (J - R) @ Q
        if group is None:
            resid = XP - (eye + h * A) @ X
            return torch.sum(resid * resid) / n_cols
        resid = XP - (eye + h * enter(A, group)) @ X
        return exit_sum(torch.sum(resid * resid), group) / n_cols

    def ineq_fn(x):
        A = (x[0] - x[1]) @ x[2]
        a = A[rows_t, cols_t]
        ls_val = -a + p1_t
        rs_val = a - p2_t
        two_val = -((a - p1_t) ** 2) + p2_t**2
        return torch.where(kinds_t == KIND_LS, ls_val,
                           torch.where(kinds_t == KIND_RS, rs_val, two_val))

    def positive_definite(p):
        # the symmetric part's Cholesky succeeds and every entry is finite:
        # the reference's test of the eigenvalues, without an eigensolver
        # under ``vmap`` (cuSOLVER's batched syev refuses 32768 lanes or more)
        info = torch.linalg.cholesky_ex(0.5 * (p + p.T)).info
        return (info == 0) & torch.isfinite(p).all()

    def manvio_fn(x):
        # simulator.py:11-33
        J, R, Q = x[0], x[1], x[2]
        v = (torch.linalg.matrix_norm(J + J.T) + torch.linalg.matrix_norm(R - R.T)
             + torch.linalg.matrix_norm(Q - Q.T))
        pd_ok = positive_definite(R) & positive_definite(Q)
        return torch.where(pd_ok, v, torch.full_like(v, math.inf))

    x0 = man.pack(tuple(as_tensor(a, dtype, device) for a in x0))
    y0 = (torch.ones(m, dtype=dtype, device=device) if y0 is None
          else as_tensor(y0, dtype, device))
    return Problem(
        manifold=man,
        cost_fn=cost_fn,
        ineq_fn=ineq_fn,
        x0=x0,
        y0=y0,
        z0=torch.zeros(0, dtype=dtype, device=device),
        num_ineq=m,
        num_eq=0,
        manvio_fn=manvio_fn,
        matmul_precision=matmul_precision,
        derivatives=derivatives,
    )


def load_problem(
    dataset_path: str,
    initialpoint: str = "a",
    x_set=(1, 2, 3, 4, 5),
    is_x_noisy: bool = True,
    h: float = 0.02,
    dtype=None,
    device=None,
) -> Problem:
    """Load a shipped instance (``coordinator.py:14-179``)."""
    d = int(loadtxt(f"{dataset_path}/dim.csv"))
    prefix = "noisyX" if is_x_noisy else "X"
    x_trajs = [loadtxt(f"{dataset_path}/{prefix}_{i}.csv") for i in x_set]
    constset = loadtxt(f"{dataset_path}/constset.csv")
    x0 = (
        loadtxt(f"{dataset_path}/initJ_{initialpoint}.csv"),
        loadtxt(f"{dataset_path}/initR_{initialpoint}.csv"),
        loadtxt(f"{dataset_path}/initQ_{initialpoint}.csv"),
    )
    y0 = loadtxt(f"{dataset_path}/initineqLagmult.csv")
    return make_problem(d, x_trajs, constset, x0, y0, h=h, dtype=dtype, device=device)


# ----------------------------------------------------------------------
# Dataset generation (generator.py parity)
# ----------------------------------------------------------------------
def _stable(A):
    """Every eigenvalue of A (numpy [d, d]) in the open left half-plane."""
    return bool(np.all(np.real(np.linalg.eigvals(A)) < 0))


def _interior(d, constset, J, R, Q):
    """(J, R, Q) strictly inside the original constraints (numpy)."""
    A = (J - R) @ Q
    kinds, rows, cols, p1s, p2s = parse_constset(constset, 1.0)
    a = A[rows, cols]
    g = np.where(kinds == KIND_LS, -a + p1s,
                 np.where(kinds == KIND_RS, a - p2s, -((a - p1s) ** 2) + p2s**2))
    return bool(np.all(g < 0))


def generate_true_system(generator: torch.Generator, d: int, scaling: float = 1.0, *,
                         dtype=None, device=None):
    """``generate_trueJRQA`` (generator.py:57-66): a random point of the
    product manifold, scaled; numpy (J, R, Q, A)."""
    J, R, Q = manifold(d).unpack(
        manifold(d).random_point(generator, dtype=dtype, device=device)[0])
    s = math.sqrt(scaling)
    J, R, Q = (s * a.double().cpu().numpy() for a in (J, R, Q))
    return J, R, Q, (J - R) @ Q


def generate_constraints(rng, d: int, true_A, oneboxratio: float,
                         twoboxratio: float, min_segment_width=None,
                         max_redraws: int = 50):
    """``generate_constraints`` (generator.py:68-113), numpy on the host.

    ``min_segment_width`` (the JAX package's extension): only entries with
    |true_A[r, c]| >= 2.5 * min_segment_width are constrained, and twobox
    parameters are redrawn until the widest remaining segment clears it —
    a well-margined variant, not the reference generator."""
    true_A = np.asarray(true_A)
    num_element = true_A.size
    num_onebox = int(num_element * oneboxratio)
    num_twobox = int(num_element * twoboxratio)
    num_const = num_onebox + num_twobox
    perm = rng.permutation(num_element)
    if min_segment_width is not None:
        flat_abs = np.abs(true_A.T.reshape(-1))  # index i -> (i % d, i // d)
        perm = perm[flat_abs[perm] >= 2.5 * min_segment_width]
        if len(perm) < num_const:
            raise ValueError(
                f"min_segment_width={min_segment_width}: only {len(perm)} "
                f"of {num_element} entries have |A| >= "
                f"{2.5 * min_segment_width:.3g}; need {num_const}"
            )
    constindices = perm[:num_const]
    rowcol = np.stack([constindices % d, constindices // d], axis=1)

    def _twobox_width(ls, rs, cc, k):
        """Widest feasible segment of [ls, rs] minus the |a-cc| < |k| hole."""
        half = abs(k)
        segs = [(ls, min(rs, cc - half)), (max(ls, cc + half), rs)]
        return max((b - a for a, b in segs if b > a), default=0.0)

    constset = []
    for i in range(num_onebox):
        r, c = rowcol[i]
        aval = true_A[r, c]
        absa = abs(aval)
        ls = aval - rng.uniform(0.2, 0.8) * absa
        rs = aval + rng.uniform(0.2, 0.8) * absa
        constset.append([0, r, c, ls, rs, aval])
    for i in range(num_onebox, num_const):
        r, c = rowcol[i]
        aval = true_A[r, c]
        absa = abs(aval)
        for _ in range(max_redraws if min_segment_width else 1):
            cc = rng.uniform(0.2, 0.8) * aval
            k = cc + rng.uniform(0.2, 0.8) * (aval - cc)
            ls = -absa - rng.uniform(0.2, 0.8) * absa
            rs = absa + rng.uniform(0.2, 0.8) * absa
            if (
                min_segment_width is None
                or _twobox_width(ls, rs, cc, k) >= min_segment_width
            ):
                break
        constset.append([1, r, c, ls, rs, aval])
        constset.append([2, r, c, cc, k, aval])
    return np.asarray(constset)


def _awgn(rng, signal, snr_db):
    power = np.mean(np.abs(signal) ** 2)
    noise_power = power / (10 ** (snr_db / 10))
    return signal + np.sqrt(noise_power) * rng.standard_normal(signal.shape)


def generate_trajectory(rng, d: int, true_A, h: float, n_steps: int, snr: float):
    """``generate_XnoisyX`` (generator.py:122-135).  As the reference, the
    elementwise ``np.exp`` of ``i*h*A`` (not a matrix exponential)."""
    x0 = -1000 + 2000 * rng.random(d)
    X = np.zeros((d, n_steps))
    noisyX = np.zeros((d, n_steps))
    X[:, 0] = x0
    noisyX[:, 0] = _awgn(rng, x0, snr)
    for i in range(1, n_steps):
        expAh = np.exp(i * h * np.asarray(true_A))
        X[:, i] = expAh @ x0
        noisyX[:, i] = _awgn(rng, X[:, i], snr)
    X = X / np.linalg.norm(x0)
    noisyX = noisyX / np.linalg.norm(noisyX[:, 0])
    return X, noisyX


def feasible_entry_targets(constset):
    """Per constrained entry of A, a strictly feasible target value: the
    midpoint of the widest segment of its interval [lo, hi] (onebox and
    twobox box rows) minus its annulus holes (twobox quadratic rows,
    |a - cc| >= k), from the original constraint parameters.  Returns
    (rows, cols, targets) numpy arrays."""
    kinds, rows, cols, p1s, p2s = parse_constset(constset, 1.0)
    entries: dict = {}
    for kind, r, c, p1, p2 in zip(kinds, rows, cols, p1s, p2s):
        e = entries.setdefault(
            (int(r), int(c)), {"lo": -np.inf, "hi": np.inf, "holes": []}
        )
        if kind == KIND_LS:
            e["lo"] = max(e["lo"], float(p1))
        elif kind == KIND_RS:
            e["hi"] = min(e["hi"], float(p2))
        else:
            # |a - cc| >= |k|; k enters the constraint as k^2 and the
            # generator's k = cc + u*(aval - cc) is negative for aval < 0
            half = abs(float(p2))
            e["holes"].append((float(p1) - half, float(p1) + half))
    t_rows, t_cols, t_vals = [], [], []
    for (r, c), e in sorted(entries.items()):
        lo, hi = e["lo"], e["hi"]
        if not np.isfinite(lo):  # guard: entry without a box row
            lo = min([h[0] for h in e["holes"]], default=-1.0) - 1.0
        if not np.isfinite(hi):
            hi = max([h[1] for h in e["holes"]], default=1.0) + 1.0
        segs = [(lo, hi)]
        for a, b in e["holes"]:
            segs = [
                s
                for seg in segs
                for s in ((seg[0], min(seg[1], a)), (max(seg[0], b), seg[1]))
            ]
        segs = [s for s in segs if s[1] > s[0]]
        if not segs:
            raise ValueError(
                f"entry ({r},{c}): tightened feasible set is empty"
            )
        lo_s, hi_s = max(segs, key=lambda s: s[1] - s[0])
        t_rows.append(r)
        t_cols.append(c)
        t_vals.append(0.5 * (lo_s + hi_s))
    return (
        np.asarray(t_rows, np.int32),
        np.asarray(t_cols, np.int32),
        np.asarray(t_vals),
    )


def generate_interior_initialpoint_lsq(
    generator: torch.Generator,
    d: int,
    constset,
    scaling: float = 1.0,
    interior_scaling: float = 0.95,
    max_tries: int = 10,
    cg_iters: int = 1000,
    *,
    lanes=None,
    dtype=None,
    device=None,
):
    """Feasible-interior starts by least squares (the JAX package's
    extension beyond d = 5): drive the constrained entries of
    A(J, R, Q) = (J - R) Q to the strictly feasible targets of
    ``feasible_entry_targets`` with the Riemannian conjugate gradient, from
    random points.  A is Hurwitz for any R, Q > 0, so a start fails only
    by missing the interior.

    All starts run as lanes of one lane-masked ``conjugate_gradient`` a
    try; a try redraws only the lanes not yet accepted.  Returns numpy
    (J, R, Q, A), each [d, d] with ``lanes=None`` or [lanes, d, d]."""
    from riptrm_torch.solvers.subsolvers import conjugate_gradient

    del interior_scaling  # targets use the original set (feasible_entry_targets)
    dtype, device = resolve(dtype, device)
    man = manifold(d)
    b = 1 if lanes is None else int(lanes)
    t_rows, t_cols, t_vals = feasible_entry_targets(constset)
    rows_t = torch.tensor(t_rows, dtype=torch.int64, device=device)
    cols_t = torch.tensor(t_cols, dtype=torch.int64, device=device)
    targets = torch.tensor(t_vals, dtype=dtype, device=device)
    s = math.sqrt(scaling)

    def cost_lane(x):
        a = ((x[0] - x[1]) @ x[2])[rows_t, cols_t]
        return torch.sum((a - targets) ** 2)

    def rgrad(x):
        return man.egrad2rgrad(x, vmap(grad(cost_lane))(x))

    found = [None] * b
    for _ in range(max_tries):
        todo = [i for i in range(b) if found[i] is None]
        if not todo:
            break
        x0 = s * man.random_point(generator, len(todo), dtype=dtype, device=device)
        res = conjugate_gradient(man, vmap(cost_lane), rgrad, x0,
                                 max_iterations=cg_iters, min_gradient_norm=1e-12)
        pts = res.point.double().cpu().numpy()
        for lane, i in enumerate(todo):
            J, R, Q = pts[lane]
            if _interior(d, constset, J, R, Q) and _stable((J - R) @ Q):
                found[i] = (J, R, Q, (J - R) @ Q)
    if any(f is None for f in found):
        raise ValueError("Cannot find a feasible and interior initial point.")
    if lanes is None:
        return found[0]
    return tuple(np.stack([f[j] for f in found]) for j in range(4))


def generate_interior_initialpoint(
    generator: torch.Generator,
    d: int,
    constset,
    scaling: float = 1.0,
    interior_scaling: float = 0.95,
    ralm_option=None,
    max_tries: int = 10,
    *,
    dtype=None,
    device=None,
):
    """RALM-based feasible-interior initial point search
    (``generator.py:137-223``): a random start, a feasibility problem with
    tightened constraints, retried until A is stable and strictly inside
    the original constraints.  Returns numpy (J, R, Q, A)."""
    from riptrm_torch.solvers.ralm import RALM

    dtype, device = resolve(dtype, device)
    man = manifold(d)
    s = math.sqrt(scaling)
    option = {"maxtime": 100, "maxiter": 4, "tolresid": 1e-2, "verbosity": 0}
    option.update(ralm_option or {})
    for _ in range(max_tries):
        x_start = man.unpack(s * man.random_point(generator, dtype=dtype, device=device)[0])
        problem = make_problem(d, [], constset, x_start, h=0.02,
                               interior_scaling=interior_scaling, cost_zero=True,
                               dtype=dtype, device=device)
        out = RALM(option).run(problem)
        J, R, Q = (a.double().cpu().numpy() for a in man.unpack(out.x))
        A = (J - R) @ Q
        g = make_problem(d, [], constset, (J, R, Q), cost_zero=True, dtype=torch.float64,
                         device="cpu")
        interior = bool(np.all(g.ineq_val(g.x0[None]).numpy() <= 0))
        if _stable(A) and interior:
            return J, R, Q, A
    raise ValueError("Cannot find a feasible and interior initial point.")

"""Roofline of the port's batched tCG kernels on an NVIDIA H100.

Counterpart of ``riptrm_tpu/experiment/roofline.py``.  Each row times one
kernel in steady state, every lane running exactly ``maxinner`` tCG
iterations per call, and states it against

* the card's peaks (``PEAK_FP32``, CUDA cores without tensor cores, and
  ``PEAK_HBM``; the H100 SXM data sheet at 700 W): ``bound_us_per_call``
  is the larger of the call's operations over ``PEAK_FP32`` and its bytes
  over ``PEAK_HBM``, and ``bound_by`` names the larger; ``pct_of_bound`` is
  that bound over the measured time.  Bytes: each input read once and each
  output written once, except Zs when it exceeds the L2 (``L2_BYTES``):
  then no memory of the card holds it from one pass to the next, and it
  counts once per pass;
* the bare matvec chain (K5, ``ops/kernels.py::bare_matvec_chain``) at the
  kernel's own matvec shape, orientation and precision ('highest': the
  port's tCG kernels compute their matvec in full FP32):
  ``pct_of_bare_matvec_chain`` is tCG iterations/s over chain iterations/s.
  The chain is the card's fastest scheme for that product, not the tCG
  kernel's own: the sphere rows' left chain keeps Z resident across a
  cooperative grid of all SMs, where K3 streams Zs through one SM per
  lane, so it reads far below 100 % even with free control flow.

Rows: the sphere kernel (K3) at n in ``--sizes``, B in ``--batches``; the
Stiefel-bound kernel (K4) at St(``--stiefel-n``, ``--stiefel-p``), B in
``--batches`` (one row per B: one Hopper kernel serves both TPU layouts,
K4a lane-major and K4b p-major); and one row of K6, the chained
barrier-Hessian matvec on a cooperative grid, at n = ``HBM_N``, where Zs
(64 MB) is above the L2.  K6 has no other entry point.  The sphere rows
take n up to the left chain's limit (``left_chain_plan``: resident up to
2112 on 132 SMs, then the right chain on the transposes up to 7200); a
larger n in ``--sizes`` is refused before any row runs.

Timing: CUDA events around a window of k calls (at least ~50 ms) after a
warm-up, the median of three windows.  The tCG calls are a data-coupled
chain (each call's gradient is the first one plus 1e-6 of the previous
eta, re-projected), and the iteration counts are read back from the
kernels' stats after the window.  Operations are counted from what the
algorithm needs, for each lane's own iterations.  Needs CUDA; it raises
without it.

    python -m riptrm_torch.experiment.roofline [--sizes 1000] [--batches 16 64 128]
        [--maxinner 64] [--stiefel-n 128] [--stiefel-p 8]
        [--out result/roofline_torch.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics

import numpy as np
import torch

from riptrm_torch.manifolds import Sphere, Stiefel
from riptrm_torch.ops import kernels as k
from riptrm_torch.utils.devices import cuda_device, name_and_power_limit

PEAK_FP32 = 67e12  # FLOP/s, H100 SXM CUDA cores (no tensor cores), 700 W
PEAK_HBM = 3.35e12  # B/s, H100 SXM HBM3
L2_BYTES = 50 * 2**20  # H100 SXM L2
WINDOW_MS = 50.0
F32 = 4  # bytes
HBM_N = 4000  # K6's row: Zs 64 MB

# Operations per vector entry beyond the matvec, counted from the kernels'
# loops (csrc/*.cu): Hw(v) on the sphere (two projection dots and the
# update) 14; a chain iteration adds its norm and division, 17; a sphere
# tCG iteration adds the CG dots and updates, 40.  On Stiefel, per entry of
# an n x p frame: 10 p (V S and the two projections' X'U and X sym(X'U))
# plus 30 for the rest.
CHAIN_VEC_OPS = 17
SPHERE_TCG_VEC_OPS = 40
STIEFEL_TCG_PP_OPS = 10
STIEFEL_TCG_VEC_OPS = 30


# ---------------------------------------------------------------------------
# accounting: (operations, bytes) of one call, and its bound on the card
# ---------------------------------------------------------------------------
def roofline_bound(ops: float, nbytes: float):
    """(bound_us, bound_by): the least time the card could take for ``ops``
    FP32 operations and ``nbytes`` bytes, and which of the two sets it
    ('operations' or 'bytes')."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e6, "operations" if t_ops >= t_bytes else "bytes"


def zs_bytes(n: int, passes) -> float:
    """Bytes of an [n, n] float32 Zs read by ``passes`` passes over it: once
    while it fits the L2, else once per pass (at least one)."""
    once = F32 * n * n
    return float(once if once <= L2_BYTES else max(1, passes) * once)


def chain_work(n: int, n_iters: int):
    """K1 / K6: n_iters normalised Hw(v) on the sphere.  Reads Zs, x, y/c,
    v0; writes v."""
    return (n_iters * (2.0 * n * n + CHAIN_VEC_OPS * n),
            zs_bytes(n, n_iters) + F32 * 4.0 * n)


def bare_chain_work(n: int, vectors: int, n_iters: int):
    """K5: n_iters passes over ``vectors`` rows (left) or columns (right) of
    length n, each a matvec (2 n^2) and a normalisation (3 n).  Reads Z and
    v0; writes v."""
    return (n_iters * vectors * (2.0 * n * n + 3.0 * n),
            zs_bytes(n, n_iters) + F32 * 2.0 * vectors * n)


def sphere_tcg_work(n: int, lane_iters):
    """K2 / K3: each lane's own tCG iterations (``lane_iters`` [B]) times
    2 n^2 + 40 n.  Reads Zs (once per iteration of the longest lane beyond
    the L2), xs, ws, grads, radii; writes etas, Hetas and the [B, 2] stats."""
    iters = np.asarray(lane_iters, np.float64)
    b = iters.size
    ops = float(iters.sum()) * (2.0 * n * n + SPHERE_TCG_VEC_OPS * n)
    return ops, zs_bytes(n, iters.max(initial=0)) + F32 * (5.0 * b * n + 3.0 * b)


def stiefel_tcg_work(n: int, p: int, lane_iters):
    """K4: each lane's own tCG iterations times 2 n^2 p + 10 n p^2 + 30 n p.
    Reads Zs (as K3), d, xs, ws, grads, ss, radii; writes etas, Hetas,
    stats."""
    iters = np.asarray(lane_iters, np.float64)
    b = iters.size
    ops = float(iters.sum()) * (2.0 * n * n * p + STIEFEL_TCG_PP_OPS * n * p * p
                                + STIEFEL_TCG_VEC_OPS * n * p)
    return ops, (zs_bytes(n, iters.max(initial=0))
                 + F32 * (p + 5.0 * b * n * p + b * p * p + 3.0 * b))


# ---------------------------------------------------------------------------
# steady-state cases
# ---------------------------------------------------------------------------
def _tiny_z(rng, n):
    """Symmetric Z scaled tiny: the quadratic is dominated by the positive
    barrier weights, so the tCG meets no negative curvature; the matvec's
    cost does not depend on the values."""
    z = rng.standard_normal((n, n))
    return (z + z.T) * (1e-3 / (2 * np.sqrt(n)))


def sphere_case(n: int, b: int, device):
    """B lanes of the sphere tCG in steady state: barrier weights w
    log-uniform over 1e6 and x proportional to 1/w, so that the
    curvature shift corr = 2 x'Zs x + x'(w o x) stays O(1) and the
    Hessian's spectrum spans the whole spread (an x of O(1) entries puts
    corr near the mean weight and CG converges in ~15 steps); an infinite
    radius; tangent gradients.  CG's model then decreases above float32
    noise for more than 64 iterations.  Returns the kernel's arguments
    (zs, xs, ws, grads, radii), float32 on ``device``."""
    rng = np.random.default_rng(0)
    z = _tiny_z(rng, n)
    ws = 10.0 ** (6.0 * rng.random((b, n)))
    xs = 1.0 / ws
    xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    grads = 0.1 * rng.standard_normal((b, n))
    grads -= np.sum(grads * xs, axis=1, keepdims=True) * xs
    radii = np.full(b, 1e18)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (z, xs, ws, grads, radii))


def stiefel_case(n: int, b: int, p: int, device):
    """B lanes of the Stiefel-bound tCG in steady state at St(n, p): frames
    0.7 Q strictly inside |x| <= 0.8, equal multipliers on the two bound
    sides (unequal ones make Hw indefinite through S), log-uniform over
    1e8 (at 1e4, the JAX script's spread, CG's model stops
    decreasing after ~40-55 iterations in float32), an infinite radius,
    tangent gradients.  Returns the kernel's arguments (zs, d, xs, ws, ss,
    grads, radii), float32 on ``device``."""
    rng = np.random.default_rng(1)
    m = n * p
    z = torch.tensor(_tiny_z(rng, n), dtype=torch.float32, device=device)
    d = 1.0 + torch.arange(p - 1, -1, -1, dtype=torch.float32, device=device) / p
    q = np.linalg.qr(rng.standard_normal((b, n, p)))[0]
    xs = torch.tensor(0.7 * q, dtype=torch.float32, device=device)
    y_half = 10.0 ** (8.0 * rng.random((b, m))) * 1e-2
    ys = torch.tensor(np.concatenate([y_half, y_half], axis=1), dtype=torch.float32,
                      device=device)
    cs = torch.cat([(0.8 - xs).reshape(b, m), (0.8 + xs).reshape(b, m)], dim=1)
    grads = torch.tensor(0.1 * rng.standard_normal((b, n, p)), dtype=torch.float32,
                         device=device)
    grads = Stiefel(n, p).proj(xs, grads)
    ws, ss = k.stiefel_bound_pieces(z, d, xs, ys, cs)
    radii = torch.full((b,), 1e18, dtype=torch.float32, device=device)
    return z, d, xs, ws, ss, grads, radii


def steady_calls(kernel, case, manifold, xs, maxinner: int):
    """(call, couple) for a case whose last two arguments are the gradient
    and the radii: ``call(g)`` runs the tCG kernel with gradient g and every
    stop but ``maxinner`` out of reach (mininner = maxinner, kappa = 1e-30);
    ``couple(eta)`` is the next call's gradient, the case's plus 1e-6 eta,
    re-projected onto the tangent space at ``xs``."""
    *fixed, grads, radii = case

    def call(g):
        return kernel(*fixed, g, radii, maxinner=maxinner, mininner=maxinner, kappa=1e-30)

    def couple(eta):
        return manifold.proj(xs, grads + 1e-6 * eta)

    return call, couple


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------
def _event_ms(run):
    """CUDA-event time of ``run()`` in ms; returns (ms, run's result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _windows(run, repeats=3):
    """Median time of ``repeats`` runs, and the last run's result."""
    times = []
    for _ in range(repeats):
        ms, out = _event_ms(run)
        times.append(ms)
    return statistics.median(times), out


def time_tcg_chain(call, couple, g0, warmup=3):
    """Window of k data-coupled calls (k so it lasts >= WINDOW_MS).
    Returns (ms of the window, k, iterations [k, B] of the last window)."""

    def chain(calls):
        def run():
            g, its = g0, []
            for _ in range(calls):
                eta, _, it, _ = call(g)
                its.append(it)
                g = couple(eta)
            return torch.stack(its)

        return run

    probe, _ = _event_ms(chain(warmup))
    calls = max(1, math.ceil(WINDOW_MS / (probe / warmup)))
    ms, its = _windows(chain(calls))
    return ms, calls, its.cpu()


def time_chain(fn, probe_iters=16):
    """Iterations of a chain kernel ``fn(n_iters)`` per call and its time:
    a probe call sizes n_iters so one call lasts >= WINDOW_MS.  Returns
    (ms per call, n_iters)."""
    fn(probe_iters)  # warm-up (and the build, on first use)
    probe, _ = _event_ms(lambda: fn(probe_iters))
    n_iters = max(probe_iters, math.ceil(probe_iters * WINDOW_MS / probe))
    ms, _ = _windows(lambda: fn(n_iters))
    return ms, n_iters


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------
def tcg_row(kernel_name, n, b, ms, calls, its, work, chain_iters_per_s, **extra):
    """One tCG row from a window of ``calls`` calls lasting ``ms`` with
    per-call, per-lane iterations ``its`` [calls, B]; ``work(lane_iters)``
    gives (operations, bytes) of one call."""
    window_s = ms / 1e3
    trips = float(its.max(dim=1).values.sum())  # a call lasts as its slowest lane
    ops = bytes_call = 0.0
    for row in its.numpy():
        o, nb = work(row)
        ops += o
        bytes_call = nb
    bound_us, bound_by = roofline_bound(ops / calls, bytes_call)
    achieved = ops / window_s
    iters_per_s = trips / window_s
    return {
        "kernel": kernel_name, "n": n, "B": b, **extra,
        "mean_tcg_iters_per_call": trips / calls,
        "kernel_calls_per_s": calls / window_s,
        "tcg_iters_per_s": iters_per_s,
        "achieved_tflops": achieved / 1e12,
        "pct_fp32_peak": 100.0 * achieved / PEAK_FP32,
        "bound_us_per_call": bound_us,
        "bound_by": bound_by,
        "pct_of_bound": 100.0 * bound_us / (ms * 1e3 / calls),
        "bare_chain_iters_per_s": chain_iters_per_s,
        "pct_of_bare_matvec_chain": 100.0 * iters_per_s / chain_iters_per_s,
    }


def sphere_row(n, b, maxinner, device):
    case = sphere_case(n, b, device)
    zs, xs, grads = case[0], case[1], case[3]
    call, couple = steady_calls(k.fused_tcg_sphere_quadratic_batched, case, Sphere(n), xs,
                                maxinner)
    ms, calls, its = time_tcg_chain(call, couple, grads)
    v0 = grads + 0.1
    chain_ms, chain_k = time_chain(lambda it: k.bare_matvec_chain(zs, v0, it, "highest", True))
    return tcg_row("fused_tcg_sphere_quadratic_batched (K3)", n, b, ms, calls, its,
                   lambda it: sphere_tcg_work(n, it), chain_k / (chain_ms / 1e3))


def stiefel_row(n, p, b, maxinner, device):
    case = stiefel_case(n, b, p, device)
    zs, xs, grads = case[0], case[2], case[5]
    call, couple = steady_calls(k.fused_tcg_stiefel_bound_batched, case, Stiefel(n, p), xs,
                                maxinner)
    ms, calls, its = time_tcg_chain(call, couple, grads)
    # the B lanes' frames side by side, [n, B p]; the chain's own plan cuts
    # them (matvec_right_plan): the denominator is the card's best scheme for
    # the product, not the tCG kernel's one CTA per lane
    v0 = grads.permute(1, 0, 2).reshape(n, b * p) + 0.1
    chain_ms, chain_k = time_chain(lambda it: k.bare_matvec_chain(zs, v0, it, "highest", False))
    return tcg_row("fused_tcg_stiefel_bound_batched (K4: one kernel for K4a lane-major "
                   "and K4b p-major)", n, b, ms, calls, its,
                   lambda it: stiefel_tcg_work(n, p, it), chain_k / (chain_ms / 1e3), p=p)


def chain_case(n: int, device):
    """(zs, x, y/c, v0) for the chained barrier-Hessian matvec: a spiked Z
    (the NonnegPCA instance's distribution), a strictly positive unit x,
    y = 1 and c = x, a unit v0; float32 on ``device``."""
    rng = np.random.default_rng(2)
    v = (rng.permutation(n) < int(0.7 * n)) / np.sqrt(int(0.7 * n))
    z = np.sqrt(0.5) * np.outer(v, v) + rng.standard_normal((n, n)) / np.sqrt(n)
    x = np.abs(rng.standard_normal(n)) + 0.1
    x /= np.linalg.norm(x)
    v0 = rng.standard_normal(n)
    v0 /= np.linalg.norm(v0)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (0.5 * (z + z.T), x, 1.0 / x, v0))


def hbm_row(device, n=HBM_N):
    """K6 on one chain at n: time per iteration against its bound."""
    args = chain_case(n, device)
    ms, n_iters = time_chain(lambda it: k.chained_barrier_matvec_hbm(*args, it))
    ops, nbytes = chain_work(n, n_iters)
    bound_us, bound_by = roofline_bound(ops, nbytes)
    return {
        "kernel": "chained_barrier_matvec_hbm (K6)", "n": n, "n_iters": n_iters,
        "ms_per_call": ms, "us_per_iter": ms * 1e3 / n_iters,
        "achieved_tflops": ops / (ms / 1e3) / 1e12,
        "bound_us_per_call": bound_us, "bound_by": bound_by,
        "pct_of_bound": 100.0 * bound_us / (ms * 1e3),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--sizes", type=int, nargs="+", default=[1000])
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 64, 128])
    parser.add_argument("--maxinner", type=int, default=64)
    parser.add_argument("--stiefel-n", type=int, default=128)
    parser.add_argument("--stiefel-p", type=int, default=8)
    parser.add_argument("--out", default="result/roofline_torch.json")
    args = parser.parse_args(argv)

    device = cuda_device()
    for n in args.sizes:  # each sphere row's bare chain is K5 left at [B, n]
        for b in args.batches:
            try:
                k.left_chain_plan(b, n, k._sms(device))
            except ValueError as e:
                parser.error(f"--sizes {n}: no bare chain for the sphere row at B={b}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for n in args.sizes:
        for b in args.batches:
            emit(sphere_row(n, b, args.maxinner, device))
    for b in args.batches:
        emit(stiefel_row(args.stiefel_n, args.stiefel_p, b, args.maxinner, device))
    emit(hbm_row(device))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "device": torch.cuda.get_device_name(device),
                "name_and_power_limit": name_and_power_limit(),
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "peaks": {"fp32_flops": PEAK_FP32, "hbm_bytes_per_s": PEAK_HBM},
                "rows": rows,
            }, f, indent=1)
    return rows


if __name__ == "__main__":
    main()

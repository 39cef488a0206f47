"""The fused-tCG kernels: wrappers, plain versions, launch counters.

Counterparts of the Pallas kernels the RIPTRM tCG paths run in
``riptrm_tpu/ops/pallas_kernels.py``.  The CUDA sources are
``riptrm_torch/csrc/sphere_tcg.cu`` (the sphere-quadratic kernels below)
and ``riptrm_torch/csrc/stiefel_tcg.cu`` (the Stiefel-bound kernel, at the
end of this module), built into one library by ``ops/_build.py``.

* ``chained_barrier_matvec`` replaces ``chained_barrier_matvec``
  (``_chain_kernel``): K normalised barrier-Hessian applications.
* ``fused_tcg_sphere_quadratic`` replaces ``pallas_tcg_sphere_quadratic``
  (``_tcg_kernel``): the whole tCG of one lane.
* ``fused_tcg_sphere_quadratic_batched`` replaces
  ``pallas_tcg_sphere_quadratic_batched`` (``_tcg_kernel_batched``): B
  lanes against one shared Zs, which every batched sweep calls directly
  (the JAX package reaches it through a ``custom_vmap`` rule).
* ``fused_tcg_stiefel_bound_batched`` replaces both Stiefel-bound kernels,
  ``pallas_tcg_stiefel_bound_batched`` (K4a, lane-major) and
  ``pallas_tcg_stiefel_bound_batched_pmajor`` (K4b, p-major), which compute
  one function in two TPU layouts: the whole tCG of B lanes on St(n, p).

K2 and K3 are one CUDA kernel (one CTA per lane), K2 being its launch at
B = 1; each keeps its own wrapper and counter.  What bounds them on an H100
is the read of Zs (n^2 * 4 bytes) per tCG iteration and lane, streamed
through L2 (see the source note in ``sphere_tcg.cu``).

Which version runs is decided by where the tensors lie: on the CPU the
wrapper runs its plain PyTorch version; on a CUDA device it launches the
kernel, or raises (a missing ``nvcc``, a failed build or a failed launch
is an error, never a fallback).  Each wrapper's ``launches`` attribute
counts its kernel launches, and nothing else.

On the sphere, with P = I - x x', corr = 2 x'Zs x + x'(w o x), w = y / c:

    Hw(v) = -2 P(Zs v) + corr v + P(w o v).

On St(n, p), with P(U) = U - X sym(X'U) and the pieces W, S of
``stiefel_bound_pieces``:

    Hw(V) = P(-2 (Zs V) diag(d) - V S + W o V).

The kernels take float32 only: the wrappers cast their inputs to float32
and return float32 (the solver casts back to its own dtype, as the JAX
step does).
"""

from __future__ import annotations

import torch

from riptrm_torch.manifolds import Sphere, Stiefel, sym
from riptrm_torch.ops import _build
from riptrm_torch.ops.tcg import truncated_cg

# Dynamic shared memory one block may use on Hopper: 227 KB less 1 KB for
# the kernels' static reduction scratch.  The chain kernel keeps 4
# n-vectors there, the tCG kernel 8 (so n <= 7232).
MAX_SMEM_BYTES = 232448 - 1024


def _on_card(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {device}")


def _f32(*tensors):
    return [t.to(torch.float32).contiguous() for t in tensors]


def _ptr(t):
    return t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def barrier_corr(zs, xs, ws):
    """corr = 2 x'Zs x + x'(w o x) per lane: [B]."""
    zx = xs @ zs  # == Zs x by symmetry
    return 2.0 * torch.sum(zx * xs, dim=-1) + torch.sum(ws * xs * xs, dim=-1)


def sphere_hw(zs, xs, ws, corr):
    """v [B, n] -> Hw(v) [B, n] in closed form (v @ Zs == Zs v)."""

    def proj(v):
        return v - torch.sum(xs * v, dim=-1, keepdim=True) * xs

    def hw(v):
        return -2.0 * proj(v @ zs) + corr[:, None] * v + proj(ws * v)

    return hw


def tcg_target(grads, theta, kappa):
    """(target, linear_flag) per lane, as ``truncated_cg`` computes them:
    target = |r0| min(|r0|^theta, kappa), linear = kappa < |r0|^theta, with
    |r0| the 2-norm of a lane's gradient (Frobenius on a frame)."""
    norm_r0 = torch.sqrt(torch.sum(grads * grads, dim=tuple(range(1, grads.ndim))))
    target = norm_r0 * torch.clamp(norm_r0**theta, max=kappa)
    return target, (kappa < norm_r0**theta).to(grads.dtype)


def _check_smem(n, vectors):
    """The kernels keep ``vectors`` n-vectors of a lane in shared memory."""
    if vectors * n * 4 > MAX_SMEM_BYTES:
        raise ValueError(
            f"n={n}: {vectors} float32 vectors exceed the {MAX_SMEM_BYTES} bytes of "
            "shared memory a block may use"
        )


def _check_lanes(zs, xs, ws, grads, radii):
    b, n = xs.shape
    if zs.shape != (n, n) or ws.shape != (b, n) or grads.shape != (b, n):
        raise ValueError(
            f"shape mismatch: zs {tuple(zs.shape)}, xs {tuple(xs.shape)}, "
            f"ws {tuple(ws.shape)}, grads {tuple(grads.shape)}"
        )
    if radii.shape != (b,):
        raise ValueError(f"radii must be [{b}], got {tuple(radii.shape)}")


# ---------------------------------------------------------------------------
# K1: chained barrier-Hessian matvec
# ---------------------------------------------------------------------------
def chained_barrier_matvec_plain(zs, x, y_over_c, v0, n_iters: int):
    """Plain version of K1: n_iters normalised Hw applications, [n] f32."""
    zs, x, w, v = _f32(zs, x[None], y_over_c[None], v0[None])
    hw = sphere_hw(zs, x, w, barrier_corr(zs, x, w))
    for _ in range(n_iters):
        h = hw(v)
        v = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    return v[0]


def chained_barrier_matvec(zs, x, y_over_c, v0, n_iters: int):
    """K normalised Hw matvecs from v0 at the point x with weights y/c.

    ``zs`` [n, n]; ``x``, ``y_over_c``, ``v0`` [n].  Returns [n] float32.
    One CTA runs the whole chain; Zs streams from L2 every iteration."""
    if not _on_card(zs, x, y_over_c, v0):
        return chained_barrier_matvec_plain(zs, x, y_over_c, v0, n_iters)
    zs, x, w, v0 = _f32(zs, x, y_over_c, v0)
    n = x.shape[0]
    if zs.shape != (n, n) or w.shape != (n,) or v0.shape != (n,):
        raise ValueError("chained_barrier_matvec: shape mismatch")
    _check_smem(n, 4)
    corr = barrier_corr(zs, x[None], w[None]).contiguous()
    out = torch.empty_like(x)
    lib = _build.load()
    err = lib.sphere_chain_launch(
        _ptr(zs), _ptr(x), _ptr(w), _ptr(v0), _ptr(corr), _ptr(out),
        n, int(n_iters), x.device.index or 0, _stream(x.device),
    )
    _build.check(lib, err, "chained_barrier_matvec")
    chained_barrier_matvec.launches += 1
    return out


chained_barrier_matvec.launches = 0


# ---------------------------------------------------------------------------
# K2 / K3: fused Steihaug-Toint tCG
# ---------------------------------------------------------------------------
def fused_tcg_plain(zs, xs, ws, grads, radii, *, maxinner, mininner=1,
                    theta=1.0, kappa=0.1):
    """Plain version of K2/K3: ``ops/tcg.py::truncated_cg`` over the lanes,
    driven by the closed-form Hw, in float32.

    ``zs`` [n, n]; ``xs``, ``ws`` (= y/c), ``grads`` [B, n]; ``radii`` [B].
    Returns (etas [B, n], Hetas [B, n], iterations [B], codes [B])."""
    zs, xs, ws, grads, radii = _f32(zs, xs, ws, grads, radii)
    _check_lanes(zs, xs, ws, grads, radii)
    hw = sphere_hw(zs, xs, ws, barrier_corr(zs, xs, ws))
    return truncated_cg(
        Sphere(xs.shape[1]), xs, hw, grads, radii,
        theta=theta, kappa=kappa, mininner=mininner, maxinner=maxinner,
    )


def _launch_tcg(zs, xs, ws, grads, radii, maxinner, mininner, theta, kappa):
    zs, xs, ws, grads, radii = _f32(zs, xs, ws, grads, radii)
    _check_lanes(zs, xs, ws, grads, radii)
    b, n = xs.shape
    _check_smem(n, 8)
    corr = barrier_corr(zs, xs, ws).contiguous()
    target, flag = tcg_target(grads, theta, kappa)
    target, flag = target.contiguous(), flag.contiguous()
    etas = torch.empty_like(xs)
    hetas = torch.empty_like(xs)
    stats = torch.empty((b, 2), dtype=torch.int32, device=xs.device)
    if b == 0:
        return etas, hetas, stats[:, 0], stats[:, 1]
    lib = _build.load()
    err = lib.sphere_tcg_launch(
        _ptr(zs), _ptr(xs), _ptr(ws), _ptr(grads), _ptr(corr), _ptr(radii),
        _ptr(target), _ptr(flag), _ptr(etas), _ptr(hetas), _ptr(stats),
        b, n, int(maxinner), int(mininner), xs.device.index or 0, _stream(xs.device),
    )
    _build.check(lib, err, "sphere tCG kernel")
    return etas, hetas, stats[:, 0], stats[:, 1]


def fused_tcg_sphere_quadratic(zs, x, y_over_c, grad, radius, *, maxinner,
                               mininner=1, theta=1.0, kappa=0.1):
    """Fused tCG for one lane: ``x``, ``y_over_c``, ``grad`` [n], ``radius``
    a scalar.  Returns (eta [n], Heta [n], iterations, stop_code), the
    vectors float32 and the counts int32, with the stop codes of
    ``ops/tcg.py``."""
    radius = torch.as_tensor(radius, device=x.device).reshape(1)
    args = (zs, x[None], y_over_c[None], grad[None], radius)
    kw = dict(maxinner=maxinner, mininner=mininner, theta=theta, kappa=kappa)
    if _on_card(*args):
        out = _launch_tcg(*args, maxinner, mininner, theta, kappa)
        fused_tcg_sphere_quadratic.launches += 1
    else:
        out = fused_tcg_plain(*args, **kw)
    eta, heta, iters, code = out
    return eta[0], heta[0], iters[0], code[0]


fused_tcg_sphere_quadratic.launches = 0


def fused_tcg_sphere_quadratic_batched(zs, xs, ws, grads, radii, *, maxinner,
                                       mininner=1, theta=1.0, kappa=0.1):
    """Batched fused tCG: B lanes against one shared ``zs``.

    ``xs``, ``ws`` (= y/c), ``grads`` [B, n]; ``radii`` [B].  Returns
    (etas [B, n], Hetas [B, n], iterations [B], codes [B]).  A lane that
    stops is frozen at its values of that step."""
    radii = torch.broadcast_to(torch.as_tensor(radii, device=xs.device), xs.shape[:1])
    if not _on_card(zs, xs, ws, grads, radii):
        return fused_tcg_plain(zs, xs, ws, grads, radii, maxinner=maxinner,
                               mininner=mininner, theta=theta, kappa=kappa)
    out = _launch_tcg(zs, xs, ws, grads, radii, maxinner, mininner, theta, kappa)
    fused_tcg_sphere_quadratic_batched.launches += 1
    return out


fused_tcg_sphere_quadratic_batched.launches = 0


# ---------------------------------------------------------------------------
# K4a / K4b: Stiefel-bound batched fused tCG
# ---------------------------------------------------------------------------
# Threads of a CTA of the Stiefel kernel; the shared-memory plan below
# mirrors the layout ``stiefel_tcg_kernel`` carves out of dynamic shared
# memory (csrc/stiefel_tcg.cu).
STIEFEL_THREADS = 256
# Where a lane's working set lives: Zs and the 8 frames in shared memory;
# the frames there and Zs read through L2; or the frames in a global
# scratch tensor [B, 8, n, p] (read through L1/L2) and Zs through L2.
STIEFEL_ALL_SHARED, STIEFEL_ZS_GLOBAL, STIEFEL_FRAMES_GLOBAL = 0, 1, 2


def stiefel_smem_plan(n: int, p: int):
    """(placement, dynamic shared-memory bytes) of the Stiefel kernel at
    St(n, p): the first placement whose shared part fits.  Always in shared
    memory: S, sym(X'U) and its partial sums, d (``(2 + segs) p^2 + p``
    floats, segs = max(1, threads // p^2)).  Raises when even that does not
    fit."""
    segs = max(1, STIEFEL_THREADS // (p * p))
    small = (2 + segs) * p * p + p
    frames = 8 * n * p
    for mode, floats in ((STIEFEL_ALL_SHARED, n * n + frames + small),
                         (STIEFEL_ZS_GLOBAL, frames + small),
                         (STIEFEL_FRAMES_GLOBAL, small)):
        if floats * 4 <= MAX_SMEM_BYTES:
            return mode, floats * 4
    raise ValueError(
        f"St({n}, {p}): the p x p blocks alone ({small * 4} bytes) exceed the "
        f"{MAX_SMEM_BYTES} bytes of shared memory a block may use"
    )


def stiefel_bound_pieces(zs, d, xs, ys, cs):
    """W (barrier weights) and S (Lagrangian curvature block) per lane, in
    float32: W = Y1/C1 + Y2/C2 and S = sym(X'E), E = -2 Zs X D + Y1 - Y2,
    where [Y1, Y2] and [C1, C2] are the two halves of y and c [B, 2 n p].
    Lane-batched counterpart of ``_stiefel_bound_pieces``; ``xs`` [B, n, p].
    Returns (ws [B, n, p], ss [B, p, p])."""
    zs, d, xs, ys, cs = _f32(zs, d, xs, ys, cs)
    b, n, p = xs.shape
    half = lambda a, i: a[:, i * n * p:(i + 1) * n * p].reshape(b, n, p)
    y1, y2, c1, c2 = half(ys, 0), half(ys, 1), half(cs, 0), half(cs, 1)
    ws = y1 / c1 + y2 / c2
    e = -2.0 * (zs @ xs) * d + y1 - y2
    return ws, sym(xs.mT @ e)


def stiefel_hw(zs, d, xs, ws, ss):
    """V [B, n, p] -> Hw(V) [B, n, p] in closed form."""
    man = Stiefel(xs.shape[1], xs.shape[2])

    def hw(v):
        return man.proj(xs, -2.0 * (zs @ v) * d - v @ ss + ws * v)

    return hw


def _check_frames(zs, d, xs, ws, ss, grads, radii):
    b, n, p = xs.shape
    if (zs.shape != (n, n) or d.shape != (p,) or ws.shape != (b, n, p)
            or grads.shape != (b, n, p) or ss.shape != (b, p, p)):
        raise ValueError(
            f"shape mismatch: zs {tuple(zs.shape)}, d {tuple(d.shape)}, "
            f"xs {tuple(xs.shape)}, ws {tuple(ws.shape)}, ss {tuple(ss.shape)}, "
            f"grads {tuple(grads.shape)}"
        )
    if radii.shape != (b,):
        raise ValueError(f"radii must be [{b}], got {tuple(radii.shape)}")


def fused_tcg_stiefel_bound_plain(zs, d, xs, ws, ss, grads, radii, *, maxinner,
                                  mininner=1, theta=1.0, kappa=0.1):
    """Plain version of the Stiefel-bound kernel: ``ops/tcg.py::truncated_cg``
    over the lanes, driven by the closed-form Hw, in float32.

    ``zs`` [n, n]; ``d`` [p]; ``xs``, ``ws``, ``grads`` [B, n, p]; ``ss``
    [B, p, p]; ``radii`` [B].  Returns (etas [B, n, p], Hetas [B, n, p],
    iterations [B], codes [B])."""
    zs, d, xs, ws, ss, grads, radii = _f32(zs, d, xs, ws, ss, grads, radii)
    _check_frames(zs, d, xs, ws, ss, grads, radii)
    return truncated_cg(
        Stiefel(xs.shape[1], xs.shape[2]), xs, stiefel_hw(zs, d, xs, ws, ss), grads,
        radii, theta=theta, kappa=kappa, mininner=mininner, maxinner=maxinner,
    )


def _launch_stiefel(zs, d, xs, ws, ss, grads, radii, maxinner, mininner, theta, kappa):
    zs, d, xs, ws, ss, grads, radii = _f32(zs, d, xs, ws, ss, grads, radii)
    _check_frames(zs, d, xs, ws, ss, grads, radii)
    b, n, p = xs.shape
    mode, _ = stiefel_smem_plan(n, p)
    target, flag = tcg_target(grads, theta, kappa)
    target, flag = target.contiguous(), flag.contiguous()
    etas = torch.empty_like(xs)
    hetas = torch.empty_like(xs)
    stats = torch.empty((b, 2), dtype=torch.int32, device=xs.device)
    if b == 0:
        return etas, hetas, stats[:, 0], stats[:, 1]
    scratch = torch.empty(
        (b, 8, n, p) if mode == STIEFEL_FRAMES_GLOBAL else (0,),
        dtype=torch.float32, device=xs.device,
    )
    lib = _build.load()
    err = lib.stiefel_tcg_launch(
        _ptr(zs), _ptr(d), _ptr(xs), _ptr(ws), _ptr(ss), _ptr(grads), _ptr(radii),
        _ptr(target), _ptr(flag), _ptr(etas), _ptr(hetas), _ptr(stats),
        _ptr(scratch) if scratch.numel() else None,
        b, n, p, int(maxinner), int(mininner), mode, xs.device.index or 0,
        _stream(xs.device),
    )
    _build.check(lib, err, "Stiefel-bound tCG kernel")
    return etas, hetas, stats[:, 0], stats[:, 1]


def fused_tcg_stiefel_bound_batched(zs, d, xs, ws, ss, grads, radii, *, maxinner,
                                    mininner=1, theta=1.0, kappa=0.1):
    """Batched fused tCG for the ``stiefel_bound`` structure: B lanes on
    St(n, p) against one shared ``zs`` [n, n] and Brockett weights ``d``
    [p].  ``xs``, ``ws``, ``grads`` [B, n, p]; ``ss`` [B, p, p]; ``radii``
    [B] or a scalar.  Returns (etas [B, n, p], Hetas [B, n, p], iterations
    [B] int32, codes [B] int32), the outputs of both JAX wrappers; a lane
    that stops keeps its values of that step.  A single lane is B = 1."""
    radii = torch.broadcast_to(torch.as_tensor(radii, device=xs.device), xs.shape[:1])
    if not _on_card(zs, d, xs, ws, ss, grads, radii):
        return fused_tcg_stiefel_bound_plain(zs, d, xs, ws, ss, grads, radii,
                                             maxinner=maxinner, mininner=mininner,
                                             theta=theta, kappa=kappa)
    out = _launch_stiefel(zs, d, xs, ws, ss, grads, radii, maxinner, mininner, theta,
                          kappa)
    fused_tcg_stiefel_bound_batched.launches += 1
    return out


fused_tcg_stiefel_bound_batched.launches = 0

KERNEL_WRAPPERS = (
    chained_barrier_matvec,
    fused_tcg_sphere_quadratic,
    fused_tcg_sphere_quadratic_batched,
    fused_tcg_stiefel_bound_batched,
)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

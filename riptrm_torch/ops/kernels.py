"""The hand-written kernels: wrappers, plain versions, launch counters.

Counterparts of the Pallas kernels of ``riptrm_tpu/ops/pallas_kernels.py``.
The CUDA sources are ``riptrm_torch/csrc/sphere_tcg.cu`` (the sphere tCG
kernel), ``riptrm_torch/csrc/stiefel_tcg.cu`` (the Stiefel-bound kernel)
and ``riptrm_torch/csrc/matvec_chain.cu`` (the chains: K1, K5, K6), with
the reductions they share in ``csrc/reduce.cuh``, built into one library
by ``ops/_build.py``.

* ``chained_barrier_matvec`` replaces ``chained_barrier_matvec``
  (``_chain_kernel``): K normalised barrier-Hessian applications, with Zs
  resident in the shared memory of a cooperative grid.
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
* ``bare_matvec_chain`` replaces ``bare_matvec_chain``
  (``_bare_chain_kernel``, K5): K normalised batched matvecs and nothing
  else, the roofline's denominator (``experiment/roofline.py``).
* ``chained_barrier_matvec_hbm`` replaces ``chained_barrier_matvec_hbm``
  (``_chain_hbm_kernel``, K6): K1's function on a cooperative grid that
  streams Zs from device memory through bulk copies, for an n whose Zs
  lies beyond the L2.

* ``dense_solve_nan`` replaces no Pallas kernel: B dense systems a x = b by
  LU with partial pivoting, one warp a system (``csrc/dense_solve.cu``),
  for RIPM's Newton solve, where the JAX package calls
  ``jnp.linalg.solve`` (XLA's LU).  float32 at n <= ``DENSE_SOLVE_MAX_N``;
  every other system keeps ``torch.linalg.solve_ex`` (``dense_solve_plan``).
* ``stableid_barrier_hvp`` (K8) replaces no Pallas kernel: the barrier-KKT
  operator of the StableIdentification family, which RIPTRM's generic tCG
  applies once an iteration, in one launch (``csrc/stableid_hvp.cu``),
  where the JAX package takes the Hessian by autograd.  float32 at
  d <= STABLEID_HVP_MAX_D with at most STABLEID_HVP_MAX_M constraints; every
  other problem composes the operator (``stableid_hvp_plan``).  Its plain
  version is that composition (``problems/stable_identification.py::
  barrier_hvp_plain``); under ``vmap`` the mapped axis folds into the lanes.
* ``spd_cho_solve`` (K9) replaces no Pallas kernel: x^-1 u from x's
  Cholesky factor, the SPD metric's two triangular solves
  (``manifolds/spd.py::_cho_solve``), in one launch (``csrc/spd_solve.cu``),
  where the JAX package calls ``jax.scipy.linalg.cho_solve``.  float32 at
  d <= SPD_SOLVE_MAX_D, the inputs read in place by their strides; every
  other solve keeps ``torch.linalg.solve_triangular`` (``spd_solve_plan``).

K2 and K3 share their CUDA kernels, K2 being their launch at B = 1; each
keeps its own wrapper and counter.  ``tcg_plan`` picks the route before
any launch: Zs resident across a cooperative grid (``tcg_resident_kernel``:
n <= 2112 at B = 1, n <= 1056 at B = 128 on 132 SMs), else one CTA per
lane streaming Zs from L2 (``tcg_kernel``, n <= 7232), else no kernel (the
solver's plain ``truncated_cg``).  The Stiefel kernel runs each lane on a
thread-block cluster of row slices (``stiefel_plan``).

Each launch is a ``torch.library`` operator of the ``riptrm`` namespace
(``chain_resident``, ``sphere_tcg``, ``stiefel_tcg``, ``matvec_chain_left``,
``matvec_chain_right``, ``chain_hbm``, ``dense_solve``, ``stableid_hvp``,
``spd_cho_solve``; the table at the end), so a traced program
(``experiment/export_artifact.py``) holds it as one node.  The wrappers
work out the plans and call the operators, which dispatch on where the
tensors lie: on the CPU the plain
PyTorch version runs; on a CUDA device the kernel launches, or the call
raises (a missing ``nvcc``, a failed build or a failed launch is an error,
never a fallback).  Each
wrapper's ``launches`` attribute counts its kernel launches, and nothing
else; the operator's CUDA implementation counts them, so a reloaded
program counts its own.

On the sphere, with P = I - x x', corr = 2 x'Zs x + x'(w o x), w = y / c:

    Hw(v) = -2 P(Zs v) + corr v + P(w o v).

On St(n, p), with P(U) = U - X sym(X'U) and the pieces W, S of
``stiefel_bound_pieces``:

    Hw(V) = P(-2 (Zs V) diag(d) - V S + W o V).

The tCG and chain kernels take float32 only: the wrappers cast their
inputs to float32 and return float32 (the solver casts back to its own
dtype, as the JAX step does).  The dense solve never casts: a float64
system takes the library's solve.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from riptrm_torch.manifolds import Sphere, Stiefel, sym
from riptrm_torch.ops import _build
from riptrm_torch.ops.tcg import truncated_cg

# Dynamic shared memory one block may use on Hopper: 227 KB less 1 KB for
# the kernels' static reduction scratch.  The streaming tCG kernel keeps 8
# n-vectors there (so n <= 7232).
MAX_SMEM_BYTES = 232448 - 1024
# SMs of an H100 SXM: the plans of K1, K5 and K6 on the CPU, where no
# card tells its own count.
H100_SMS = 132


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


def _sms(device) -> int:
    """SMs of the card a tensor lies on; H100_SMS for the CPU."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


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


def chain_resident_plan(n: int, sms: int = H100_SMS):
    """(grid, rows per CTA, dynamic shared-memory bytes) of K1's cooperative
    grid: one CTA per SM, cut so every CTA has a row (rows = ceil(n / sms),
    grid = ceil(n / rows); 125 CTAs of 8 rows at n = 1000 on 132 SMs), the
    layout ``chain_resident_kernel`` carves (csrc/matvec_chain.cu): its
    rows of Zs, v and x, each padded to a multiple of 4 floats, w, Hw(v)
    and its rows' dot products.
    Raises when that exceeds one block's shared memory (n > 2508 on 132
    SMs, ``chain_resident_max_n``): K6 takes such an n."""
    rows = max(1, _ceil(n, sms))
    ldk = _ceil(n, 4) * 4
    nbytes = 4 * ((rows + 2) * ldk + 2 * n + rows)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"chained_barrier_matvec: n={n} needs {nbytes} bytes of shared memory per CTA "
            f"({rows} rows of Zs on each of {sms} SMs), above the {MAX_SMEM_BYTES} a block "
            "may use; use chained_barrier_matvec_hbm, which streams Zs from device memory"
        )
    return _ceil(n, rows), rows, nbytes


def chain_resident_max_n(sms: int = H100_SMS) -> int:
    """The largest n whose Zs K1 holds resident on ``sms`` SMs."""
    n = 1
    while True:
        try:
            chain_resident_plan(n + 1, sms)
        except ValueError:
            return n
        n += 1


def chained_barrier_matvec(zs, x, y_over_c, v0, n_iters: int):
    """K normalised Hw matvecs from v0 at the point x with weights y/c.

    ``zs`` [n, n] (symmetric); ``x``, ``y_over_c``, ``v0`` [n].  Returns
    [n] float32.  A cooperative grid holds Zs in its CTAs' shared memory,
    a slice of rows each, for the whole call (``chain_resident_plan``), with
    one grid-wide step per iteration.  Resident up to n = 2508 on an H100's
    132 SMs (on a CUDA tensor, the card's own SM count sets the limit); a
    larger n raises ``ValueError`` on either device, naming
    ``chained_barrier_matvec_hbm``, which takes it, as the JAX function is
    bound by VMEM and K6 by device memory.  The operator
    ``riptrm::chain_resident``."""
    _on_card(zs, x, y_over_c, v0)
    n = x.shape[0]
    grid, rows, _ = chain_resident_plan(n, _sms(x.device))
    zs, x, w, v0 = _f32(zs, x, y_over_c, v0)
    if zs.shape != (n, n) or w.shape != (n,) or v0.shape != (n,):
        raise ValueError("chained_barrier_matvec: shape mismatch")
    return torch.ops.riptrm.chain_resident(zs, x, w, v0, int(n_iters), grid, rows)


def _chain_resident_cuda(zs, x, w, v0, n_iters, grid, rows):
    n = x.shape[0]
    u = torch.empty(2 * n + grid, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load()
    err = lib.chain_resident_launch(
        _ptr(zs), _ptr(x), _ptr(w), _ptr(v0), _ptr(u), _ptr(out),
        n, n_iters, grid, rows, x.device.index or 0, _stream(x.device),
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


# The resident sphere tCG (csrc/sphere_tcg.cu::tcg_resident_kernel): a
# warp's tile of u (8 rows x 8 lanes), the most tiles of a CTA's product
# (one for each of its 16 warps) and their partial sums, the most lanes a
# CTA owns.
TCG_ROW_TILE, TCG_SLOT_TILE = 8, 8
TCG_MAX_TILES = 16
TCG_PART = TCG_MAX_TILES * TCG_ROW_TILE * TCG_SLOT_TILE
TCG_MAX_OWNED = 4
# The lanes of a product group, the most before the plan cuts the lanes
# into more groups (a group's lanes are staged together).
TCG_GROUP_LANES = 32


class TcgPlan(NamedTuple):
    """The route of K2/K3 and its launch: ``route`` "resident" (Zs across a
    cooperative grid of ``grid`` CTAs: ``groups`` lane groups x grid /
    groups row blocks of ``rows`` rows; each CTA owns up to ``owned`` lanes;
    a group's at most ``lmax`` lanes staged ``chunk`` floats at a time
    through two buffers), "stream" (one CTA per lane, Zs from L2) or
    "plain" (no kernel: the caller runs ``truncated_cg``); ``smem`` bytes
    of shared memory per CTA."""

    route: str
    grid: int
    groups: int
    rows: int
    owned: int
    lmax: int
    chunk: int
    smem: int


@functools.lru_cache(maxsize=None)
def tcg_plan(n: int, b: int, sms: int = H100_SMS) -> TcgPlan:
    """The plan of the sphere tCG at n for b lanes on ``sms`` SMs, decided
    before any launch.

    Resident where it fits: the rows of Zs cut over one CTA per SM (at
    b = 1 every CTA holds the lane whole and takes ONE grid step an
    iteration); for b > 1 the lanes cut into ceil(b / 32) product groups,
    fewer where that does not fit, each group's row blocks sharing the
    SMs (rows = ceil(n / (sms // groups))), lane l owned by CTA l % grid,
    and the largest chunk of staged deltas (a multiple of 128 floats, up to
    the whole n) that fits twice (a ring of two: one chunk lands while the
    product runs on the other; three stages of half the chunk measured
    slower on the H100, PERF.md).  Shared memory, as
    ``tcg_resident_kernel`` carves it (csrc/sphere_tcg.cu): the rows,
    padded to a multiple of 8, [rows][ldk] (ldk = n rounded up to 4), the
    owned lanes' 8 vectors [owned][8][ldk], the staged chunks
    [2][lmax][chunk] (b > 1), the product's partial sums (TCG_PART)
    and the live-lane list [b].
    Else the streaming kernel while a lane's 8 n-vectors fit one block
    (n <= 7232), else "plain": at n = 1000 the resident route takes every
    b up to 128 on 132 SMs."""
    ldk = _ceil(n, 4) * 4
    for groups in (range(min(_ceil(b, TCG_GROUP_LANES), sms), 0, -1) if b > 1 else (1,)):
        rows = _ceil(n, sms // groups)
        blocks = _ceil(n, rows)
        grid = groups * blocks
        owned = _ceil(b, grid)
        lmax = _ceil(b, groups)
        tiles = _ceil(rows, TCG_ROW_TILE) * _ceil(lmax, TCG_SLOT_TILE)
        if owned > TCG_MAX_OWNED or tiles > TCG_MAX_TILES:
            continue
        fixed = _ceil(rows, TCG_ROW_TILE) * TCG_ROW_TILE * ldk + owned * 8 * ldk + TCG_PART + b
        if b == 1:
            if 4 * fixed <= MAX_SMEM_BYTES:
                return TcgPlan("resident", grid, groups, rows, owned, lmax, 0, 4 * fixed)
            continue
        chunk = _ceil(ldk, 128) * 128
        while chunk >= 128 and 4 * (fixed + 2 * lmax * chunk) > MAX_SMEM_BYTES:
            chunk = chunk // 256 * 128  # halve, a multiple of 128
        if chunk >= 128:
            return TcgPlan("resident", grid, groups, rows, owned, lmax, chunk,
                           4 * (fixed + 2 * lmax * chunk))
    if 8 * n * 4 <= MAX_SMEM_BYTES:
        return TcgPlan("stream", b, 0, 0, 0, 0, 0, 8 * n * 4)
    return TcgPlan("plain", 0, 0, 0, 0, 0, 0, 0)


def tcg_resident_max_n(b: int, sms: int = H100_SMS) -> int:
    """The largest n at which ``tcg_plan`` keeps b lanes resident (0 for
    none)."""
    return next((n for n in range(_ceil(MAX_SMEM_BYTES, 32), 0, -1)
                 if tcg_plan(n, b, sms).route == "resident"), 0)


def _tcg_args(zs, xs, ws, grads, radii, maxinner, mininner, theta, kappa):
    """The arguments of ``riptrm::sphere_tcg``: the inputs in float32 and
    the plan's integers (``tcg_plan`` on a CUDA tensor's card; none on the
    CPU, whose plain version has no plan)."""
    zs, xs, ws, grads, radii = _f32(zs, xs, ws, grads, radii)
    _check_lanes(zs, xs, ws, grads, radii)
    b, n = xs.shape
    plan = (0,) * 7
    if xs.device.type == "cuda":
        route = tcg_plan(n, max(b, 1), _sms(xs.device))
        if route.route == "plain":
            raise ValueError(
                f"sphere tCG kernel: n={n}: neither the resident nor the streaming plan fits "
                f"(a lane's 8 float32 vectors exceed the {MAX_SMEM_BYTES} bytes of shared "
                "memory a block may use); the solver routes such an n to truncated_cg"
            )
        plan = (int(route.route == "resident"), route.grid, route.groups, route.rows,
                route.owned, route.lmax, route.chunk)
    return (zs, xs, ws, grads, radii, int(maxinner), int(mininner), float(theta),
            float(kappa), *plan)


def _launch_tcg(zs, xs, ws, grads, radii, maxinner, mininner, theta, kappa, resident, grid,
                groups, rows, owned, lmax, chunk):
    b, n = xs.shape
    dev = xs.device
    # the resident kernel forms one lane's corr itself (a grid step), which
    # saves the host the few small launches of barrier_corr
    own_corr = resident and b == 1
    corr = None if own_corr else barrier_corr(zs, xs, ws).contiguous()
    etas = torch.empty_like(xs)
    hetas = torch.empty_like(xs)
    stats = torch.empty((b, 2), dtype=torch.int32, device=dev)
    if b == 0:
        return etas, hetas, stats
    lib = _build.load()
    common = (_ptr(zs), _ptr(xs), _ptr(ws), _ptr(grads), None if own_corr else _ptr(corr),
              _ptr(radii), _ptr(etas), _ptr(hetas), _ptr(stats))
    # the kernel forms truncated_cg's target from each lane's |grad|
    if not resident:
        err = lib.sphere_tcg_launch(*common, b, n, maxinner, mininner, theta, kappa,
                                    dev.index or 0, _stream(dev))
    else:
        ldk = _ceil(n, 4) * 4
        u = torch.empty((2 if b == 1 else b) * ldk, dtype=torch.float32, device=dev)
        delta = torch.empty(b * ldk if b > 1 else 4, dtype=torch.float32, device=dev)
        alive = torch.empty(b, dtype=torch.int32, device=dev)
        err = lib.sphere_tcg_resident_launch(
            *common, _ptr(u), _ptr(delta), _ptr(alive), b, n, maxinner, mininner, theta,
            kappa, grid, groups, rows, owned, lmax, chunk, dev.index or 0, _stream(dev),
        )
    _build.check(lib, err, "sphere tCG kernel")
    return etas, hetas, stats


def _sphere_tcg_cuda(*args):
    out = _launch_tcg(*args[:-1])
    # K2 and K3 share the kernels; each wrapper counts its own launches
    if args[-1]:
        fused_tcg_sphere_quadratic.launches += 1
    else:
        fused_tcg_sphere_quadratic_batched.launches += 1
    return out


def _sphere_tcg_cpu(zs, xs, ws, grads, radii, maxinner, mininner, theta, kappa, *plan):
    etas, hetas, iters, codes = fused_tcg_plain(zs, xs, ws, grads, radii, maxinner=maxinner,
                                                mininner=mininner, theta=theta, kappa=kappa)
    return etas, hetas, torch.stack([iters, codes], dim=1)


def fused_tcg_sphere_quadratic(zs, x, y_over_c, grad, radius, *, maxinner,
                               mininner=1, theta=1.0, kappa=0.1):
    """Fused tCG for one lane: ``x``, ``y_over_c``, ``grad`` [n], ``radius``
    a scalar.  Returns (eta [n], Heta [n], iterations, stop_code), the
    vectors float32 and the counts int32, with the stop codes of
    ``ops/tcg.py``.  The operator ``riptrm::sphere_tcg`` at B = 1."""
    radius = torch.as_tensor(radius, device=x.device).reshape(1)
    args = (zs, x[None], y_over_c[None], grad[None], radius)
    _on_card(*args)
    eta, heta, stats = torch.ops.riptrm.sphere_tcg(
        *_tcg_args(*args, maxinner, mininner, theta, kappa), True)
    return eta[0], heta[0], stats[0, 0], stats[0, 1]


fused_tcg_sphere_quadratic.launches = 0


def fused_tcg_sphere_quadratic_batched(zs, xs, ws, grads, radii, *, maxinner,
                                       mininner=1, theta=1.0, kappa=0.1):
    """Batched fused tCG: B lanes against one shared ``zs``.

    ``xs``, ``ws`` (= y/c), ``grads`` [B, n]; ``radii`` [B].  Returns
    (etas [B, n], Hetas [B, n], iterations [B], codes [B]).  A lane that
    stops is frozen at its values of that step.  The operator
    ``riptrm::sphere_tcg``."""
    radii = torch.broadcast_to(torch.as_tensor(radii, device=xs.device), xs.shape[:1])
    _on_card(zs, xs, ws, grads, radii)
    etas, hetas, stats = torch.ops.riptrm.sphere_tcg(
        *_tcg_args(zs, xs, ws, grads, radii, maxinner, mininner, theta, kappa), False)
    return etas, hetas, stats[:, 0], stats[:, 1]


fused_tcg_sphere_quadratic_batched.launches = 0


# ---------------------------------------------------------------------------
# K4a / K4b: Stiefel-bound batched fused tCG
# ---------------------------------------------------------------------------
# Threads of a CTA of the Stiefel kernel, and the widest frame it takes;
# the plan below mirrors the layout ``stiefel_tcg_kernel`` carves out of
# dynamic shared memory (csrc/stiefel_tcg.cu::Layout).
STIEFEL_THREADS = 512
STIEFEL_MAX_P = 32


class StiefelPlan(NamedTuple):
    """The Stiefel kernel's launch: each lane on a thread-block cluster of
    ``slices`` CTAs holding ``rows`` rows each, the product's inner
    dimension split ``splits`` ways over the CTA's warps, the slice's Zs in
    shared memory when ``zs_shared`` (else read through L2), ``smem`` bytes
    of shared memory per CTA."""

    slices: int
    rows: int
    splits: int
    zs_shared: bool
    smem: int


def _stiefel_cols(p):
    """p rounded up to 8, 16 or 32: the columns of the kernel's frames."""
    return 8 if p <= 8 else 16 if p <= 16 else 32


def _stiefel_floats(n, p, slices, rows, splits, zs_shared):
    """The floats of shared memory of csrc/stiefel_tcg.cu::Layout."""
    pad4 = lambda a: _ceil(a, 4) * 4
    pc = _stiefel_cols(p)
    np2 = p * (p + 1) // 2
    ldr = _ceil(rows, 32) * 32
    part = splits * rows * (pc + 4) if splits > 1 else 0  # the product's split sums
    return ((n * ldr if zs_shared else 0) + n * (pc + 4) + pad4(7 * rows * (pc + 1))
            + 3 * pc * pc + pc + part + slices * (8 + 2 * pad4(np2)) + pad4(np2))


@functools.lru_cache(maxsize=None)
def stiefel_plan(n: int, p: int, b: int, sms: int = H100_SMS,
                 clusters: tuple | None = None) -> StiefelPlan:
    """The plan of the Stiefel kernel at St(n, p) for b lanes on ``sms``
    SMs, decided before any launch: the largest cluster of 8, 4, 2, 1 CTAs
    (at most n) of which the card holds b at once (``clusters``: the most
    clusters of 1, 2, 4 and 8 CTAs co-resident, ``stiefel_max_clusters`` on
    the card; by default sms // slices), so that no lane waits for a second
    wave; a larger cluster only where nothing fits at the first, rows =
    ceil(n / slices) per CTA, the product's inner dimension split over the
    warps its tasks (32 rows by 8 columns) leave spare, halved until their
    partial sums fit, and the slice's Zs in shared memory where it fits
    beside the rest.  St(128, 8): B = 128 -> 1 slice, B = 64 -> 2, B = 16 -> 8
    (where the card holds 16 clusters of 8), all with Zs in shared memory;
    St(512, 32), B = 16 -> 8 slices of 64 rows, Zs through L2.  Raises for
    p > 32 and
    where even Zs through L2 leaves the whole delta and the slice's frames
    beyond one block's shared memory (on 132 SMs at b = 1: St(n, 8) for
    n > 2864, St(n, 16) for n > 1568, St(n, 32) for n > 704): the solver
    routes those to ``truncated_cg``."""
    if not 1 <= p <= STIEFEL_MAX_P:
        raise ValueError(f"St({n}, {p}): the Stiefel kernel takes 1 <= p <= {STIEFEL_MAX_P}")
    most = dict(zip((1, 2, 4, 8), clusters or (sms, sms // 2, sms // 4, sms // 8)))
    sizes = [s for s in (1, 2, 4, 8) if s == 1 or s <= n]
    first = max(s for s in sizes if s == 1 or b <= most[s])
    for slices in (s for s in sizes if s >= first):
        rows = _ceil(n, slices)
        # warps over (32 rows, 8 columns) tasks; the spare ones split j
        tasks = _ceil(rows, 32) * (_stiefel_cols(p) // 8)
        most = max(1, STIEFEL_THREADS // 32 // tasks)
        for zs_shared in (True, False):
            for splits in sorted({max(1, most >> k) for k in range(5)}, reverse=True):
                nbytes = 4 * _stiefel_floats(n, p, slices, rows, splits, zs_shared)
                if nbytes <= MAX_SMEM_BYTES:
                    return StiefelPlan(slices, rows, splits, zs_shared, nbytes)
    raise ValueError(
        f"St({n}, {p}): the whole delta and a slice's frames exceed the {MAX_SMEM_BYTES} "
        "bytes of shared memory a block may use, even on a cluster of 8 with Zs read "
        "through L2"
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


@functools.lru_cache(maxsize=None)
def stiefel_clusters(device_index: int) -> tuple:
    """The most clusters of 1, 2, 4 and 8 CTAs of the Stiefel kernel the
    card holds at once (``stiefel_plan``'s ``clusters``)."""
    lib = _build.load()
    out = tuple(lib.stiefel_max_clusters(s, device_index) for s in (1, 2, 4, 8))
    if min(out) < 0:
        _build.check(lib, -min(out), "stiefel_max_clusters")
    return out


def _launch_stiefel(zs, d, xs, ws, ss, grads, radii, maxinner, mininner, theta, kappa,
                    plan):
    b, n, p = xs.shape
    dev = xs.device.index or 0
    etas = torch.empty_like(xs)
    hetas = torch.empty_like(xs)
    stats = torch.empty((b, 2), dtype=torch.int32, device=xs.device)
    if b == 0:
        return etas, hetas, stats
    lib = _build.load()
    slices, rows, splits, zs_shared = plan
    # the kernel forms truncated_cg's target from each lane's |grad|
    err = lib.stiefel_tcg_launch(
        _ptr(zs), _ptr(d), _ptr(xs), _ptr(ws), _ptr(ss), _ptr(grads), _ptr(radii),
        _ptr(etas), _ptr(hetas), _ptr(stats), b, n, p, maxinner, mininner, theta, kappa,
        slices, rows, splits, int(zs_shared), dev, _stream(xs.device),
    )
    _build.check(lib, err, "Stiefel-bound tCG kernel")
    return etas, hetas, stats


def _stiefel_tcg_cuda(zs, d, xs, ws, ss, grads, radii, maxinner, mininner, theta, kappa,
                      *plan):
    out = _launch_stiefel(zs, d, xs, ws, ss, grads, radii, maxinner, mininner, theta, kappa,
                          plan)
    fused_tcg_stiefel_bound_batched.launches += 1
    return out


def _stiefel_tcg_cpu(zs, d, xs, ws, ss, grads, radii, maxinner, mininner, theta, kappa,
                     *plan):
    etas, hetas, iters, codes = fused_tcg_stiefel_bound_plain(
        zs, d, xs, ws, ss, grads, radii, maxinner=maxinner, mininner=mininner, theta=theta,
        kappa=kappa)
    return etas, hetas, torch.stack([iters, codes], dim=1)


def fused_tcg_stiefel_bound_batched(zs, d, xs, ws, ss, grads, radii, *, maxinner,
                                    mininner=1, theta=1.0, kappa=0.1):
    """Batched fused tCG for the ``stiefel_bound`` structure: B lanes on
    St(n, p) against one shared ``zs`` [n, n] and Brockett weights ``d``
    [p].  ``xs``, ``ws``, ``grads`` [B, n, p]; ``ss`` [B, p, p]; ``radii``
    [B] or a scalar.  Returns (etas [B, n, p], Hetas [B, n, p], iterations
    [B] int32, codes [B] int32), the outputs of both JAX wrappers; a lane
    that stops keeps its values of that step.  A single lane is B = 1.  The
    operator ``riptrm::stiefel_tcg``."""
    radii = torch.broadcast_to(torch.as_tensor(radii, device=xs.device), xs.shape[:1])
    on_card = _on_card(zs, d, xs, ws, ss, grads, radii)
    zs, d, xs, ws, ss, grads, radii = _f32(zs, d, xs, ws, ss, grads, radii)
    _check_frames(zs, d, xs, ws, ss, grads, radii)
    plan = (0, 0, 0, False)
    if on_card:
        b, n, p = xs.shape
        found = stiefel_plan(n, p, max(b, 1), _sms(xs.device),
                             stiefel_clusters(xs.device.index or 0))
        plan = (found.slices, found.rows, found.splits, found.zs_shared)
    etas, hetas, stats = torch.ops.riptrm.stiefel_tcg(
        zs, d, xs, ws, ss, grads, radii, int(maxinner), int(mininner), float(theta),
        float(kappa), *plan)
    return etas, hetas, stats[:, 0], stats[:, 1]


fused_tcg_stiefel_bound_batched.launches = 0


# ---------------------------------------------------------------------------
# K5: bare matvec chain
# ---------------------------------------------------------------------------
PRECISIONS = {"highest": 0, "high": 1, "default": 2}
# The right-orientation chain (csrc/matvec_chain.cu): threads of a CTA and
# a thread's tile of w (4 rows x 4 columns).
MATVEC_RIGHT_THREADS = 256
RIGHT_TILE = 4
# The left-orientation chain: threads of a CTA, and a warp's tile of w
# (rows of v x columns of Z) in registers.
MATVEC_LEFT_THREADS = 256
LEFT_TILE = 8


def bf16_round(a):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def _check_chain(zs, v, precision, left):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    n = zs.shape[0]
    if zs.shape != (n, n) or v.ndim != 2 or v.shape[1 if left else 0] != n:
        raise ValueError(f"shape mismatch: zs {tuple(zs.shape)}, v0 {tuple(v.shape)}, "
                         f"left={left}")


def bare_matvec_chain_plain(zs, v0, n_iters: int, precision: str = "high",
                            left: bool = True):
    """Plain version of K5: ``n_iters`` passes of v <- v @ Z (``left``, v
    [r, n]) or v <- Z @ v (v [n, c]), each row (left) or column then divided
    by sqrt(sum w^2 + 1e-30).  ``precision`` rounds the operands as the TPU
    does: 'highest' full float32, 'high' the bf16x3 split hi*hi + hi*lo +
    lo*hi, 'default' one product of bf16-rounded operands; the products are
    float32 matmuls (TF32 must be off on the card).  Returns float32."""
    zs, v = _f32(zs, v0)
    _check_chain(zs, v, precision, left)
    mm = (lambda a, b: a @ b) if left else (lambda a, b: b @ a)  # a from v, b from Z
    z_hi = bf16_round(zs)
    z_lo = bf16_round(zs - z_hi)
    for _ in range(n_iters):
        if precision == "highest":
            w = mm(v, zs)
        elif precision == "default":
            w = mm(bf16_round(v), z_hi)
        else:
            v_hi = bf16_round(v)
            v_lo = bf16_round(v - v_hi)
            w = mm(v_hi, z_hi) + mm(v_hi, z_lo) + mm(v_lo, z_hi)
        w2 = torch.sum(w * w, dim=1 if left else 0, keepdim=True)
        v = w / torch.sqrt(w2 + 1e-30)
    return v


class LeftPlan(NamedTuple):
    """K5 left's cooperative grid: ``col_groups`` x ``row_groups`` CTAs; a
    CTA holds ``cols`` columns of Z and computes them for ``rows`` rows of
    v, staging ``chunk`` rows at a time; ``smem`` bytes of shared memory."""

    col_groups: int
    row_groups: int
    cols: int
    rows: int
    chunk: int
    smem: int


def matvec_left_plan(r: int, n: int, sms: int = H100_SMS) -> LeftPlan:
    """The plan of K5 left for v [r, n] on ``sms`` SMs, one CTA per SM: the
    r rows cut into min(4, r // 8) row groups, halved until the plan fits,
    at least 1 (fewer CTAs read each row of v, and at n = 1000 each cut
    measured faster than the one before, PERF.md), the n columns of Z over
    the SMs left for each row group (cols = ceil(n / (sms // row_groups)):
    16 columns, 126 CTAs at n = 1000, r = 16).
    Shared memory, as ``chain_left_kernel`` carves it
    (csrc/matvec_chain.cu): the columns transposed and padded ([cols
    rounded up to 8][n rounded up to 4]), the staged rows of v ([chunk][n
    rounded up to 4]; chunk a multiple of 8 rows, the group's rows split
    into as few equal chunks as fit), the group's block of w, its norms and
    the warps' tiles.  Raises when not even 8 staged rows fit at one row
    group: n > 2112 on 132 SMs."""
    for g in (g for g in (4, 2, 1) if g <= max(1, r // 8)):
        g = min(g, max(r, 1), sms)
        rows = _ceil(r, g)
        g = _ceil(r, rows) if rows else 1
        cols = _ceil(n, sms // g)
        cp = _ceil(cols, LEFT_TILE) * LEFT_TILE
        ldk = _ceil(n, 4) * 4
        fixed = cp * ldk + rows * (cp + 1) + (MATVEC_LEFT_THREADS // 32) * LEFT_TILE * LEFT_TILE
        most = (MAX_SMEM_BYTES // 4 - fixed) // ldk // LEFT_TILE * LEFT_TILE
        if most >= LEFT_TILE:
            chunk = _ceil(_ceil(rows, _ceil(rows, most)), LEFT_TILE) * LEFT_TILE
            return LeftPlan(_ceil(n, cols), g, cols, rows, chunk, 4 * (fixed + chunk * ldk))
    raise ValueError(
        f"bare_matvec_chain left: n={n}, r={r}: the columns of Z a CTA holds and "
        f"{LEFT_TILE} staged rows of v exceed the {MAX_SMEM_BYTES} bytes of shared memory a "
        f"block may use on {sms} SMs"
    )


class RightPlan(NamedTuple):
    """K5 right: ``groups`` groups of ``cols`` columns of v, each a cluster of
    ``slices`` CTAs holding ``rows`` rows of Z; ``split`` threads share a
    tile's inner dimension; Z in shared memory when ``zs_shared``, else read
    through L2; ``smem`` bytes of shared memory per CTA."""

    cols: int
    groups: int
    slices: int
    rows: int
    split: int
    zs_shared: bool
    smem: int


def matvec_right_plan(n: int, c: int, sms: int = H100_SMS,
                      precision: str = "highest") -> RightPlan:
    """The plan of K5 right for Z [n, n] and v [n, c] on ``sms`` SMs: groups
    of 8 columns (4 when c <= 4, or when 8 do not fit), each group's n rows
    of Z cut into the most slices of the cluster sizes 8, 4, 2, 1 that keep
    groups x slices <= sms (16 groups x 8 slices of 16 rows at [128, 128],
    128 groups x 1 slice at [128, 1024]); rows = ceil(n / slices) rounded
    up to 4.
    Shared memory, as ``chain_right_kernel`` carves it (csrc/matvec_chain.cu):
    the group's v by pass parity ([2][slices rows][cols]), the slice's rows
    of Z transposed ([n][rows], twice for 'high': hi and lo) when they fit,
    the threads' partial tiles when the inner dimension is split and the
    slices' column sums of squares by parity.  Where Z does
    not fit, the CTA reads it through L2.  Raises when not even v fits at 4
    columns (n > 7200 on 132 SMs)."""
    for cols in ((8, 4) if c > 4 else (4,)):
        groups = _ceil(c, cols)
        slices = next(s for s in (8, 4, 2, 1)  # 8: the portable cluster size
                      if s == 1 or (groups * s <= sms and s <= _ceil(n, RIGHT_TILE)))
        rows = _ceil(_ceil(n, slices), RIGHT_TILE) * RIGHT_TILE
        tiles = rows // RIGHT_TILE * (cols // RIGHT_TILE)
        split = max(1, MATVEC_RIGHT_THREADS // tiles)
        base = (2 * rows * slices * cols + 2 * slices * cols
                + (MATVEC_RIGHT_THREADS * RIGHT_TILE * RIGHT_TILE if split > 1 else 0))
        zs = (2 if precision == "high" else 1) * n * rows
        for shared, floats in ((True, base + zs), (False, base)):
            if floats * 4 <= MAX_SMEM_BYTES:
                return RightPlan(cols, groups, slices, rows, split, shared, floats * 4)
    raise ValueError(
        f"bare_matvec_chain right: n={n}: v at 4 columns ({2 * n * 4 * 4} bytes) exceeds the "
        f"{MAX_SMEM_BYTES} bytes of shared memory a block may use"
    )


def left_chain_plan(r: int, n: int, sms: int = H100_SMS, precision: str = "highest"):
    """The route of K5 left for v [r, n] on ``sms`` SMs: (True, LeftPlan)
    while Z fits resident across the left chain's cooperative grid
    (``matvec_left_plan``, n <= 2112 on 132 SMs), else (False, RightPlan):
    the right chain on the transposes, Z' v' with Z' = Z^T and v' = v^T,
    whose column norms are the left chain's row norms and whose bf16
    splits round both operands alike (``matvec_right_plan``, n <= 7200).
    Raises above that."""
    try:
        return True, matvec_left_plan(r, n, sms)
    except ValueError:
        return False, matvec_right_plan(n, r, sms, precision)


def bare_matvec_chain(zs, v0, n_iters: int, precision: str = "high", left: bool = True):
    """K normalised batched matvecs and nothing else (see the plain
    version): ``zs`` [n, n], ``v0`` [r, n] (``left``) or [n, c].  Returns
    float32 of v0's shape.

    Left runs on a cooperative grid with Z resident in shared memory
    (``matvec_left_plan``; n <= 2112 on an H100) and above that as the
    right chain on the transposes (``left_chain_plan``); right on groups
    of columns, each a thread-block cluster of row slices of Z exchanging
    their blocks of w through distributed shared memory
    (``matvec_right_plan``; n <= 7200 on an H100, a larger n raises on the
    card).  Both read Z as it is given.  On the CPU the plain version
    takes any n.  The operators ``riptrm::matvec_chain_left`` and
    ``riptrm::matvec_chain_right``."""
    on_card = _on_card(zs, v0)
    _check_chain(zs, v0, precision, left)
    zs, v0 = _f32(zs, v0)
    prec = PRECISIONS[precision]
    if not on_card:  # the plain version has no plan
        chain = torch.ops.riptrm.matvec_chain_left if left else torch.ops.riptrm.matvec_chain_right
        return chain(zs, v0, int(n_iters), prec, *(0,) * (5 if left else 4))
    sms = _sms(v0.device)
    resident = False
    if left:
        resident, plan = left_chain_plan(*v0.shape, sms, precision)
    else:
        plan = matvec_right_plan(*v0.shape, sms, precision)
    if resident:
        return torch.ops.riptrm.matvec_chain_left(
            zs, v0, int(n_iters), prec, plan.col_groups, plan.row_groups, plan.cols,
            plan.rows, plan.chunk)
    if left:  # the right chain on the transposes
        zs, v0 = zs.mT.contiguous(), v0.mT.contiguous()
    out = torch.ops.riptrm.matvec_chain_right(zs, v0, int(n_iters), prec, plan.cols,
                                             plan.slices, plan.rows, plan.zs_shared)
    return out.mT.contiguous() if left else out


def _matvec_chain_left_cuda(z, v0, n_iters, prec, col_groups, row_groups, cols, rows, chunk):
    out = torch.empty_like(v0)
    if v0.numel() == 0:
        return out
    r, n = v0.shape
    dev = v0.device
    wbuf = torch.empty((2, r, _ceil(n, 4) * 4), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.matvec_chain_left_launch(
        _ptr(z), _ptr(v0), _ptr(out), _ptr(wbuf), r, n, n_iters, prec, col_groups,
        row_groups, cols, rows, chunk, dev.index or 0, _stream(dev),
    )
    _build.check(lib, err, "bare_matvec_chain")
    bare_matvec_chain.launches += 1
    return out


def _matvec_chain_right_cuda(z, v0, n_iters, prec, cols, slices, rows, zs_shared):
    out = torch.empty_like(v0)
    if v0.numel() == 0:
        return out
    n, c = v0.shape
    dev = v0.device
    lib = _build.load()
    err = lib.matvec_chain_right_launch(
        _ptr(z), _ptr(v0), _ptr(out), n, c, n_iters, prec, cols, slices, rows,
        int(zs_shared), dev.index or 0, _stream(dev),
    )
    _build.check(lib, err, "bare_matvec_chain")
    bare_matvec_chain.launches += 1
    return out


_PRECISION_NAMES = {v: k for k, v in PRECISIONS.items()}


def _matvec_chain_left_cpu(z, v0, n_iters, prec, *plan):
    return bare_matvec_chain_plain(z, v0, n_iters, _PRECISION_NAMES[prec], True)


def _matvec_chain_right_cpu(z, v0, n_iters, prec, *plan):
    return bare_matvec_chain_plain(z, v0, n_iters, _PRECISION_NAMES[prec], False)


bare_matvec_chain.launches = 0


# ---------------------------------------------------------------------------
# K6: chained barrier-Hessian matvec with Zs beyond the L2
# ---------------------------------------------------------------------------
# K6's ring (csrc/matvec_chain.cu): consumer warps, the most stages, and
# the most floats a stage holds (8 KB).
HBM_WARPS = 8
HBM_MAX_STAGES = 32
HBM_PIECE = 2048


class HbmPlan(NamedTuple):
    """K6's cooperative grid: ``grid`` CTAs, each claiming at most ``cap``
    rows of Zs an iteration, each row streamed in ``pieces`` chunks of at
    most ``piece`` floats through a ring of ``stages`` stages; x and w in
    shared memory when ``xw_shared``; ``smem`` bytes of shared memory per
    CTA."""

    grid: int
    cap: int
    pieces: int
    piece: int
    stages: int
    xw_shared: bool
    smem: int


def chain_hbm_plan(n: int, sms: int = H100_SMS) -> HbmPlan:
    """The plan of K6 at n on ``sms`` SMs: one CTA per SM (grid = min(sms,
    n)), each claiming up to twice its even share of rows an iteration (cap
    = min(n, 2 ceil(n / grid))), a row cut into the fewest chunks of at most
    HBM_PIECE floats, each a multiple of 4 (16 bytes), and as many stages as
    fit, a multiple of the HBM_WARPS consumer warps, up to HBM_MAX_STAGES.
    x and w sit in shared memory (read by every CTA on every iteration)
    where they leave room for two stages per warp, else they are read from
    global memory (at n = 4000: chunks of 8000 bytes, x and w in shared
    memory, 16 stages, 128 KB in flight).
    Shared memory, as ``chain_hbm_kernel`` carves it (csrc/matvec_chain.cu):
    the stages, v (n rounded up to 4), the claimed rows' chunk sums and row
    table (cap x (pieces + 2)), and x and w.  Takes every n that two
    n-vectors leave in one block's shared memory (``_check_smem(n, 2)``: n
    <= 28928), and raises above."""
    _check_smem(n, 2)
    grid = max(1, min(sms, n))
    cap = min(n, 2 * _ceil(n, grid))
    pieces = _ceil(n, HBM_PIECE)
    ldk = _ceil(n, 4) * 4
    while True:
        piece = _ceil(_ceil(n, pieces), 4) * 4
        for xw_shared, least in ((True, 2), (False, 1)):
            fixed = ldk * (3 if xw_shared else 1) + cap * (pieces + 2)
            per_warp = (MAX_SMEM_BYTES // 4 - fixed) // (HBM_WARPS * piece)
            stages = HBM_WARPS * min(per_warp, HBM_MAX_STAGES // HBM_WARPS)
            if per_warp >= least:
                return HbmPlan(grid, cap, pieces, piece, stages, xw_shared,
                               4 * (stages * piece + fixed))
        pieces += 1


def chained_barrier_matvec_hbm(zs, x, y_over_c, v0, n_iters: int):
    """K1's function (``chained_barrier_matvec``; its plain version is this
    one's) for an n whose Zs does not fit near one SM: on the H100, Zs
    above the 50 MB L2, n >= ~3600 in float32.

    ``zs`` [n, n] (symmetric); ``x``, ``y_over_c``, ``v0`` [n].  Returns [n]
    float32.  The TPU function's ``block`` (a VMEM budget for its streaming
    buffers, from ``pick_hbm_block``) and its padding of n to a multiple of
    128 have no counterpart: a cooperative grid of one CTA per SM
    (``chain_hbm_plan``), each claiming rows of Zs as it goes and streaming
    them from device memory through a ring of bulk copies that runs on
    across the iteration's grid-wide step (csrc/matvec_chain.cu).  n <= 28928; a
    larger n raises on either device.  The operator ``riptrm::chain_hbm``."""
    _on_card(zs, x, y_over_c, v0)
    n = x.shape[0]
    plan = chain_hbm_plan(n, _sms(x.device))
    zs, x, w, v0 = _f32(zs, x, y_over_c, v0)
    if zs.shape != (n, n) or w.shape != (n,) or v0.shape != (n,):
        raise ValueError("chained_barrier_matvec_hbm: shape mismatch")
    return torch.ops.riptrm.chain_hbm(zs, x, w, v0, int(n_iters), plan.grid, plan.pieces,
                                      plan.piece, plan.stages, plan.xw_shared)


def _chain_hbm_cuda(zs, x, w, v0, n_iters, grid, pieces, piece, stages, xw_shared):
    n = x.shape[0]
    corr = barrier_corr(zs, x[None], w[None]).contiguous()
    u = torch.empty(2 * n, dtype=torch.float32, device=x.device)
    counters = torch.zeros(1 + max(1, n_iters), dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load()
    err = lib.chain_hbm_launch(
        _ptr(zs), _ptr(x), _ptr(w), _ptr(v0), _ptr(corr), _ptr(u), _ptr(counters),
        _ptr(counters[1:]), _ptr(out), n, n_iters, grid, pieces, piece, stages,
        int(xw_shared), x.device.index or 0, _stream(x.device),
    )
    _build.check(lib, err, "chained_barrier_matvec_hbm")
    chained_barrier_matvec_hbm.launches += 1
    return out


chained_barrier_matvec_hbm.launches = 0


# ---------------------------------------------------------------------------
# The dense Newton solve: B systems a x = b by LU with partial pivoting
# ---------------------------------------------------------------------------
# Systems a block, one warp each (csrc/dense_solve.cu's kSolveWarps).
DENSE_SOLVE_WARPS = 4
# The largest n the kernel takes: a thread holds up to two rows of the
# system in registers (2 x 64 of its 255), which sets the limit.  Shared
# memory holds a warp's staged matrix, then U and the eliminated right-hand
# side (csrc/dense_solve.cu::warp_floats; 67.6 KB a block at n = 64).
DENSE_SOLVE_MAX_N = 64


class DenseSolvePlan(NamedTuple):
    rows: int  # rows of the system a thread holds (1: n <= 32, 2: n <= 64)
    grid: int  # blocks of DENSE_SOLVE_WARPS systems
    smem: int  # dynamic shared memory a block, bytes


def dense_solve_plan(n: int, b: int):
    """The kernel's plan for b systems of size n, or None where it takes no
    such system (n above DENSE_SOLVE_MAX_N, or n < 1)."""
    if not 1 <= n <= DENSE_SOLVE_MAX_N:
        return None
    return DenseSolvePlan(1 if n <= 32 else 2, _ceil(b, DENSE_SOLVE_WARPS),
                          4 * DENSE_SOLVE_WARPS * (n * (n | 1) + n))


def dense_lu_plain(a, b):
    """The elimination of ``dense_solve_plain``: (U and the eliminated
    right-hand side, in the swapped row order; the pivot row of each step,
    LAPACK's ``ipiv`` less one; singular lanes).  ``a`` [B, n, n], ``b``
    [B, n], any float dtype."""
    u, y = a.clone(), b.clone()
    lanes, n = y.shape
    idx = torch.arange(lanes, device=a.device)
    pivots = torch.empty((lanes, n), dtype=torch.long, device=a.device)
    singular = torch.zeros(lanes, dtype=torch.bool, device=a.device)
    for k in range(n):
        # torch.argmax takes the first of equal maxima: the lowest position
        p = k + torch.argmax(u[:, k:, k].abs(), dim=1)
        pivots[:, k] = p
        row_k, row_p, y_k, y_p = u[idx, k].clone(), u[idx, p].clone(), y[idx, k], y[idx, p]
        u[idx, k], u[idx, p] = row_p, row_k
        y[idx, k], y[idx, p] = y_p, y_k
        piv = u[:, k, k]
        singular |= piv == 0
        # by division: two equal rows give l = 1 exactly, so an exact zero
        # pivot where the matrix has one
        l = u[:, k + 1:, k] / torch.where(singular, torch.ones_like(piv), piv)[:, None]
        u[:, k + 1:, k + 1:] -= l[:, :, None] * u[:, k, None, k + 1:]
        y[:, k + 1:] -= l * y[:, k, None]
    return u, y, pivots, singular


def dense_solve_plain(a, b):
    """Plain version of the dense solve: the kernel's algorithm over lanes
    in PyTorch.  Unblocked LU with partial pivoting (the largest |a_ik|,
    ties to the lowest position in the swapped order, as LAPACK's isamax;
    NaN counts as the largest), multipliers by division, then back
    substitution column by column from the last.  A lane whose LU meets an
    exact zero pivot, or whose answer is not finite, reads NaN whole.
    [B, n] in the inputs' dtype."""
    u, x, _, singular = dense_lu_plain(a, b)
    for k in reversed(range(x.shape[1])):
        x[:, k] = x[:, k] / u[:, k, k]
        x[:, :k] -= u[:, :k, k] * x[:, k, None]
    ok = ~singular & torch.isfinite(x).all(dim=-1)
    return torch.where(ok[:, None], x, torch.full_like(x, float("nan")))


def dense_solve_nan(a, b):
    """``a x = b`` for B systems, ``a`` [B, n, n] (any strides) and ``b``
    [B, n]; [B, n], NaN on the lanes whose matrix is singular (XLA's solve
    returns non-finite values there, torch's raises).

    float32 with n <= DENSE_SOLVE_MAX_N (``dense_solve_plan``) takes the
    operator ``riptrm::dense_solve``: on a CUDA device the kernel
    (csrc/dense_solve.cu), one launch; on the CPU its plain version.  Every
    other system (float64, which is never cast down; n above the limit)
    takes ``torch.linalg.solve_ex`` and NaN where ``info != 0``."""
    n = a.shape[-1]
    if a.dim() != 3 or a.shape[1] != n or b.shape != a.shape[:2] or b.dtype != a.dtype:
        raise ValueError(f"dense_solve_nan: a {tuple(a.shape)} {a.dtype} and b "
                         f"{tuple(b.shape)} {b.dtype} are not [B, n, n] and [B, n] of one dtype")
    plan = dense_solve_plan(n, a.shape[0]) if a.dtype == torch.float32 else None
    if plan is None:
        sol, info = torch.linalg.solve_ex(a, b)
        return torch.where((info != 0)[:, None], torch.full_like(sol, float("nan")), sol)
    _on_card(a, b)
    return torch.ops.riptrm.dense_solve(a, b, plan.rows, plan.grid)


def _dense_solve_cuda(a, b, rows, grid):
    # the kernel reads A row-major or column-major (RIPM's symmetrised
    # materialisation is the latter): no copy of the matrices for either
    transposed = not a.is_contiguous() and a.mT.is_contiguous()
    a = a.mT if transposed else a.contiguous()
    b = b.contiguous()
    x = torch.empty_like(b)
    lib = _build.load()
    err = lib.dense_solve_launch(_ptr(a), _ptr(b), _ptr(x), b.shape[0], b.shape[1], rows, grid,
                                 int(transposed), a.device.index or 0, _stream(a.device))
    _build.check(lib, err, "dense_solve_nan")
    dense_solve_nan.launches += 1
    return x


dense_solve_nan.launches = 0


# ---------------------------------------------------------------------------
# StableIdentification's barrier-KKT operator (K8): one launch a product
# ---------------------------------------------------------------------------
# Warps a block (csrc/stableid_hvp.cu's kHvpWarps); a lane takes d threads
# of a warp, 32 // d lanes a warp.
STABLEID_HVP_WARPS = 4
# The widest point the kernel takes: a thread holds a row of every d x d
# block and Q whole in registers (8 + 8 x 8 floats at d = 8), and a warp
# holds at least one lane.
STABLEID_HVP_MAX_D = 8
# The most constraints: their entries, kinds and p1 sit in a block's shared
# memory, and each thread walks them all for those on its row.
STABLEID_HVP_MAX_M = 64


def stableid_hvp_plan(d: int, m: int):
    """The kernel's plan for StableIdentification at width d with m
    constraints: the lanes a block holds (32 // d a warp), or None where it
    takes no such problem (d above STABLEID_HVP_MAX_D or m above
    STABLEID_HVP_MAX_M)."""
    if not (1 <= d <= STABLEID_HVP_MAX_D and 0 <= m <= STABLEID_HVP_MAX_M):
        return None
    return STABLEID_HVP_WARPS * (32 // d)


def stableid_barrier_hvp(x, g, y, c, dx, *, gram, idx, lin, two, p1, scale):
    """Hw(dx) = Hess L[dx] + Gx(y * Gxaj(dx) / c) of a StableIdentification
    problem (``problems/stable_identification.py::Derivatives``) at the
    points ``x`` [B, 3, d, d] with the Lagrangian's Euclidean gradient in A
    ``g`` [B, d, d], multipliers ``y`` and slacks ``c`` [B, m], along
    ``dx`` [B, 3, d, d]; the instance's X X' ``gram`` [d, d], constrained
    entries ``idx`` [m] (row * d + column, int64), kinds ``lin``, ``two``
    and parameters ``p1`` [m], and ``scale`` 2 h^2 / N.

    float32 within ``stableid_hvp_plan``'s limits, through the operator
    ``riptrm::stableid_hvp``: on a CUDA device the kernel
    (csrc/stableid_hvp.cu), one launch; on the CPU its plain version, the
    composition bit for bit (``barrier_hvp_plain``).  Anything else
    raises: the caller composes the operator instead."""
    d, m = x.shape[-1], idx.shape[0]
    lanes = (dx.shape[0], 3, d, d)
    if (x.shape != lanes or dx.shape != lanes or g.shape != (lanes[0], d, d)
            or y.shape != (lanes[0], m) or c.shape != y.shape or gram.shape != (d, d)
            or {t.shape for t in (idx, lin, two, p1)} != {(m,)} or idx.dtype != torch.int64
            or {t.dtype for t in (x, g, y, c, dx, gram, lin, two, p1)} != {torch.float32}
            or stableid_hvp_plan(d, m) is None):
        raise ValueError(f"stableid_barrier_hvp: x {tuple(x.shape)} {x.dtype}, dx "
                         f"{tuple(dx.shape)}, g {tuple(g.shape)}, y {tuple(y.shape)} and c "
                         f"{tuple(c.shape)} with {m} constraints: not float32 lanes the "
                         "kernel's plan takes")
    return torch.ops.riptrm.stableid_hvp(x, g, y, c, dx, gram, idx, lin, two, p1, scale)


def _stableid_hvp_cuda(x, g, y, c, dx, gram, idx, lin, two, p1, scale):
    d, m, batch = x.shape[-1], idx.shape[0], dx.shape[0]
    out = torch.empty_like(dx)
    lib = _build.load()
    grid = _ceil(batch, stableid_hvp_plan(d, m))
    err = lib.stableid_hvp_launch(*(_ptr(t) for t in (x, g, y, c, dx, gram, idx, lin, two, p1,
                                                      out)),
                                  scale, batch, d, m, grid, x.device.index or 0,
                                  _stream(x.device))
    _build.check(lib, err, "stableid_barrier_hvp")
    stableid_barrier_hvp.launches += 1
    return out


def _stableid_hvp_cpu(*args):
    # the family's module imports this one
    from riptrm_torch.problems.stable_identification import barrier_hvp_plain

    return barrier_hvp_plain(*args)


def _stableid_hvp_vmap(info, in_dims, x, g, y, c, dx, *consts):
    """A mapped axis on the lanes' tensors (exact mode's materialisation
    maps the operator over basis directions) folds into the lanes: one
    call over size x B lanes, the unmapped tensors repeated."""
    if any(dim is not None for dim in in_dims[5:]):
        raise NotImplementedError("riptrm::stableid_hvp: the instance's constants are mapped")
    size = info.batch_size
    flat = [(t.movedim(dim, 0) if dim is not None else t.expand((size,) + t.shape)
             ).reshape((-1,) + t.shape[1 if dim is None else 2:])
            for t, dim in zip((x, g, y, c, dx), in_dims[:5])]
    out = torch.ops.riptrm.stableid_hvp(*flat, *consts)
    return out.unflatten(0, (size, -1)), 0


stableid_barrier_hvp.launches = 0


# ---------------------------------------------------------------------------
# The SPD metric's Cholesky solve (K9): x^-1 u in one launch
# ---------------------------------------------------------------------------
# Threads a block (csrc/spd_solve.cu's kSolveThreads); one thread a
# (system, right-hand column), 256 // d systems a block.
SPD_SOLVE_THREADS = 256
# The widest system the kernel takes: a thread holds its column (d floats)
# in registers, and a block stages its systems' L and u in static shared
# memory (16 KB at d = 8).
SPD_SOLVE_MAX_D = 8


def spd_solve_plan(d: int):
    """The kernel's plan for d x d systems: the systems a block holds
    (256 // d), or None where it takes no such system (d above
    SPD_SOLVE_MAX_D, or d < 1)."""
    if not 1 <= d <= SPD_SOLVE_MAX_D:
        return None
    return SPD_SOLVE_THREADS // d


def spd_cho_solve_plain(l, u):
    """Plain version of the Cholesky solve: the kernel's order of
    operations over systems in PyTorch.  Forward substitution, y_i = (u_i -
    sum_{j<i} L_ij y_j) / L_ii, then back substitution, x_i = (y_i -
    sum_{j>i} L_ji x_j) / L_ii, each sum from its lowest j, one row of d
    columns at a time.  [..., d, d], contiguous, in the inputs' dtype."""
    d = l.shape[-1]
    x = [None] * d
    for i in range(d):
        acc = u[..., i, :]
        for j in range(i):
            acc = acc - l[..., i, j, None] * x[j]
        x[i] = acc / l[..., i, i, None]
    for i in reversed(range(d)):
        acc = x[i]
        for j in range(i + 1, d):
            acc = acc - l[..., j, i, None] * x[j]
        x[i] = acc / l[..., i, i, None]
    return torch.stack(x, dim=-2)


def spd_cho_solve(l, u):
    """x^-1 u for a batch of d x d systems from x's lower Cholesky factor
    ``l`` [..., d, d] and right-hand sides ``u`` of the same shape, both
    float32 at d within ``spd_solve_plan``'s limit, in any strides; [..., d,
    d], contiguous.  A system whose factor holds a NaN reads NaN whole.

    Through the operator ``riptrm::spd_cho_solve``: on a CUDA device the
    kernel (csrc/spd_solve.cu), one launch, reading both inputs in place;
    on the CPU its plain version.  Anything else raises: the caller takes
    the library's two triangular solves instead (``manifolds/spd.py``)."""
    d = l.shape[-1]
    if (l.shape != u.shape or l.ndim < 2 or l.shape[-2] != d
            or {l.dtype, u.dtype} != {torch.float32} or spd_solve_plan(d) is None):
        raise ValueError(f"spd_cho_solve: l {tuple(l.shape)} {l.dtype} and u {tuple(u.shape)} "
                         f"{u.dtype}: not float32 systems of one shape the kernel's plan takes")
    _on_card(l, u)
    return torch.ops.riptrm.spd_cho_solve(l, u)


def _lead_levels(shape, *strides):
    """The leading axes of tensors of one ``shape``, merged where every
    tensor's strides let two neighbours be read as one: [(size, (each
    tensor's stride))], axes of size 1 dropped."""
    levels = []
    for n, st in zip(shape, zip(*strides)):
        if n == 1:
            continue
        if levels and all(p == n * q for p, q in zip(levels[-1][1], st)):
            levels[-1] = (levels[-1][0] * n, st)
        else:
            levels.append((n, st))
    return levels


def _spd_cho_solve_cuda(l, u):
    d = l.shape[-1]
    out = torch.empty(u.shape, dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    lead = l.shape[:-2]
    levels = _lead_levels(lead, l.stride()[:-2], u.stride()[:-2])
    if len(levels) > 2:  # three or more levels: read as one contiguous batch
        l, u = l.contiguous(), u.contiguous()
        levels = _lead_levels(lead, l.stride()[:-2], u.stride()[:-2])
    (outer, (lo, uo)), (inner, (li, ui)) = ([(1, (0, 0))] * 2 + levels)[-2:]
    lib = _build.load()
    grid = max(1, _ceil(outer * inner, spd_solve_plan(d)))
    err = lib.spd_solve_launch(_ptr(l), _ptr(u), _ptr(out), outer, inner, lo, li,
                               l.stride(-2), l.stride(-1), uo, ui, u.stride(-2), u.stride(-1),
                               d, grid, l.device.index or 0, _stream(l.device))
    _build.check(lib, err, "spd_cho_solve")
    spd_cho_solve.launches += 1
    return out


spd_cho_solve.launches = 0

KERNEL_WRAPPERS = (
    chained_barrier_matvec,
    fused_tcg_sphere_quadratic,
    fused_tcg_sphere_quadratic_batched,
    fused_tcg_stiefel_bound_batched,
    bare_matvec_chain,
    chained_barrier_matvec_hbm,
    dense_solve_nan,
    stableid_barrier_hvp,
    spd_cho_solve,
)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# ---------------------------------------------------------------------------
# The kernels as operators of the ``riptrm`` namespace
# ---------------------------------------------------------------------------
# Each launch is a ``torch.library`` operator, so that a traced program
# (``experiment/export_artifact.py``) holds it as one node and a reloaded
# program launches the kernel.  The CUDA implementation launches the kernel
# and counts the launch; the CPU one is the plain version; the fake one gives
# the outputs' shapes and dtypes.  Defined through ``Library.define/impl``:
# the dispatcher calls the Python implementation directly (PERF.md gives the
# cost of a call on the card).  Plans are worked out in the wrappers and
# passed as integers; a kernel allocates its scratch and outputs itself.
_LIB = torch.library.Library("riptrm", "DEF")


def _same(t):
    return t.new_empty(t.shape)


def _with_stats(xs):
    return _same(xs), _same(xs), xs.new_empty((xs.shape[0], 2), dtype=torch.int32)


def _contiguous(launch):
    """The kernels read their tensors through raw pointers, row-major: a
    reloaded program hands them over in the strides its graph gives."""
    return lambda *args: launch(*(a.contiguous() if isinstance(a, torch.Tensor) else a
                                  for a in args))


_OPS = {
    # name: (schema, CUDA (its strides settled), CPU, fake)
    "chain_resident": (
        "(Tensor zs, Tensor x, Tensor w, Tensor v0, int n_iters, int grid, int rows) -> Tensor",
        _contiguous(_chain_resident_cuda),
        lambda zs, x, w, v0, n_iters, *plan: chained_barrier_matvec_plain(zs, x, w, v0, n_iters),
        lambda zs, x, *rest: _same(x),
    ),
    "sphere_tcg": (
        "(Tensor zs, Tensor xs, Tensor ws, Tensor grads, Tensor radii, int maxinner, "
        "int mininner, float theta, float kappa, int resident, int grid, int groups, int rows, "
        "int owned, int lmax, int chunk, bool single) -> (Tensor, Tensor, Tensor)",
        _contiguous(_sphere_tcg_cuda),
        lambda *args: _sphere_tcg_cpu(*args[:-1]),
        lambda zs, xs, *rest: _with_stats(xs),
    ),
    "stiefel_tcg": (
        "(Tensor zs, Tensor d, Tensor xs, Tensor ws, Tensor ss, Tensor grads, Tensor radii, "
        "int maxinner, int mininner, float theta, float kappa, int slices, int rows, "
        "int splits, bool zs_shared) -> (Tensor, Tensor, Tensor)",
        _contiguous(_stiefel_tcg_cuda),
        _stiefel_tcg_cpu,
        lambda zs, d, xs, *rest: _with_stats(xs),
    ),
    "matvec_chain_left": (
        "(Tensor z, Tensor v0, int n_iters, int prec, int col_groups, int row_groups, "
        "int cols, int rows, int chunk) -> Tensor",
        _contiguous(_matvec_chain_left_cuda),
        _matvec_chain_left_cpu,
        lambda z, v0, *rest: _same(v0),
    ),
    "matvec_chain_right": (
        "(Tensor z, Tensor v0, int n_iters, int prec, int cols, int slices, int rows, "
        "bool zs_shared) -> Tensor",
        _contiguous(_matvec_chain_right_cuda),
        _matvec_chain_right_cpu,
        lambda z, v0, *rest: _same(v0),
    ),
    "chain_hbm": (
        "(Tensor zs, Tensor x, Tensor w, Tensor v0, int n_iters, int grid, int pieces, "
        "int piece, int stages, bool xw_shared) -> Tensor",
        _contiguous(_chain_hbm_cuda),
        lambda zs, x, w, v0, n_iters, *plan: chained_barrier_matvec_plain(zs, x, w, v0, n_iters),
        lambda zs, x, *rest: _same(x),
    ),
    "dense_solve": (
        "(Tensor a, Tensor b, int rows, int grid) -> Tensor",
        _dense_solve_cuda,
        lambda a, b, *plan: dense_solve_plain(a, b),
        lambda a, b, *plan: _same(b),
    ),
    "stableid_hvp": (
        "(Tensor x, Tensor g, Tensor y, Tensor c, Tensor dx, Tensor gram, Tensor idx, "
        "Tensor lin, Tensor two, Tensor p1, float scale) -> Tensor",
        _contiguous(_stableid_hvp_cuda),
        _stableid_hvp_cpu,
        lambda x, g, y, c, dx, *consts: _same(dx),
    ),
    "spd_cho_solve": (
        "(Tensor l, Tensor u) -> Tensor",
        _spd_cho_solve_cuda,
        spd_cho_solve_plain,
        lambda l, u: _same(u),
    ),
}


for _name, (_schema, _cuda, _cpu, _fake) in _OPS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"riptrm::{_name}", _fake, lib=_LIB)
torch.library.register_vmap("riptrm::stableid_hvp", _stableid_hvp_vmap, lib=_LIB)

"""GPU batched multi-start sweep throughput for any problem family.

Counterpart of ``riptrm_tpu/experiment/chip_sweep.py`` (the name is kept so
the two are easy to pair).  The reference parallelises its experimental
sweep (instances x initial points) as independent Hydra-multirun OS
processes; here the sweep is the lane axis of ONE batched solve
(``parallel/sweep.py``).  This CLI measures that sweep's throughput on the
card for an instance of any problem family at any size:

    python -m riptrm_torch.experiment.chip_sweep --problem NonnegPCA \
        --size 1000 --batch 128 --fused
    python -m riptrm_torch.experiment.chip_sweep --problem BoundedPCA \
        --size 128 --batch 16 --fused
    python -m riptrm_torch.experiment.chip_sweep --problem NonnegPCA \
        --size 32 --batch 4 --device cpu

Instances and starts (``build_sweep``): the JAX package's committed
payloads (``dataset/_cache/<problem>_s<size>_seed<seed>_b<batch>.npz``,
sliced to ``--batch``) when one covers the request, so both packages sweep
the same starts; otherwise the port's generators draw them on the host from
other random streams and the payload is cached as
``torch_<problem>_s<size>_seed<seed>_b<batch>.npz`` in ``RIPTRM_CACHE_DIR``
or the gitignored ``dataset/_cache/torch/``, never under the JAX key.

Timing (``measure_sweep``): a one-step warm-up run (reported apart, as
``warmup_s``; the kernels' build comes before it), then ``--reps`` runs of
the whole sweep, each between two CUDA events around a synchronised run
(a host clock on the CPU), averaged.  One JSON line per run: solves/s, the
median and per-lane final residuals, mean steps, the hand-written kernels'
launch counts in the timed runs, and the card's name and power limit.

float32, with the JAX chip sweep's float32 forcing floors.
``--fused`` routes the tCG to the hand-written kernels (``use_fused_tcg``:
K3 on NonnegPCA, the Stiefel-bound kernel on BoundedPCA).  Runs on CUDA
device 0 unless ``--device cpu``; raises without CUDA otherwise.

``--precision high|highest`` sets NonnegPCA's or StableIdentification's
``matmul_precision``, scoped to the problem's operators ('high' is TF32
on CUDA; without the flag the port's float32 matmuls run in full float32,
where the JAX CLI defaults to 'high').  ``--staged-precision`` (RIPTRM,
NonnegPCA) runs ``staged_precision_riptrm_solve``: phase 1 at
``--precision`` (default 'high') with the float32 floors, phase 2
continuing every lane at 'highest' with 10x tighter floors, a stall window
of 25 and ``--staged-tolresid``; both phases' residuals are reported.
With ``--fused`` the kernels compute in float32 under either setting, so
the phases differ in their tolerances only.  ``--staged-compact`` (with
``--staged-precision``) runs ``staged_precision_riptrm_compacted``: phase
2 as host-driven segments of ``--staged-segment-steps`` steps (default
100) over the lanes still running, timed by the host clock around
synchronised runs; its line reports ``segments_used``,
``phase1_median_residual`` and ``floor_improvement_x``.  As in the JAX
CLI, both flags do nothing without ``--staged-precision``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]


# ----------------------------------------------------------------------
# Instance cache: the JAX package's committed payloads (read only), and
# the port's own under a ``torch_`` prefix.  Batch-stacked keys carry the
# ``b_`` prefix; a payload written at batch B serves any batch' <= B.
# ----------------------------------------------------------------------
def _jax_cache_dir() -> pathlib.Path:
    return REPO / "dataset" / "_cache"


def _cache_dir() -> pathlib.Path:
    env = os.environ.get("RIPTRM_CACHE_DIR")  # tests point this at a tmpdir
    return pathlib.Path(env) if env else REPO / "dataset" / "_cache" / "torch"


def _find(d: pathlib.Path, prefix: str, batch: int):
    best = None
    if d.is_dir():
        for f in d.glob(f"{prefix}*.npz"):
            try:
                b = int(f.stem[len(prefix):])
            except ValueError:
                continue
            if b >= batch and (best is None or b < best[0]):
                best = (b, f)
    return None if best is None else best[1]


def _cache_load(problem_name: str, size: int, batch: int, seed: int):
    """(payload with batch axes sliced to ``batch``, "jax" or "torch"), or
    (None, None): the JAX package's payload first."""
    key = f"{problem_name}_s{size}_seed{seed}_b"
    for d, prefix, source in ((_jax_cache_dir(), key, "jax"),
                              (_cache_dir(), "torch_" + key, "torch")):
        path = _find(d, prefix, batch)
        if path is not None:
            with np.load(path) as z:
                return {k: (z[k][:batch] if k.startswith("b_") else z[k])
                        for k in z.files}, source
    return None, None


def _cache_store(problem_name: str, size: int, batch: int, seed: int, payload):
    d = _cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"torch_{problem_name}_s{size}_seed{seed}_b{batch}.npz"
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)  # atomic: concurrent readers never see a torn file
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def build_sweep(problem_name: str, size: int, batch: int, seed: int = 0, cache: bool = True,
                *, dtype=torch.float32, device=None, matmul_precision=None):
    """An instance and a stacked batch of starts -> (problem, xs0 [B, ...],
    ys0 [B, m]) on ``device`` (default CUDA device 0) in ``dtype``.
    ``cache=True`` reads the JAX package's payload or the port's own, and
    stores a payload it had to generate (``torch_`` key).
    ``matmul_precision`` goes to the families that take it (NonnegPCA,
    StableIdentification)."""
    payload, _ = _cache_load(problem_name, size, batch, seed) if cache else (None, None)
    if payload is None:
        payload = _generate_payload(problem_name, size, batch, seed)
        if cache:
            _cache_store(problem_name, size, batch, seed, payload)
    return _build_from_payload(problem_name, size, batch, payload, dtype=dtype, device=device,
                               matmul_precision=matmul_precision)


def _rosenbrock_k(n: int) -> int:
    """Grassmann frame width: the reference ships k=3 at its small n; the
    scaled-up chip instances (n >= 256) use k=8."""
    return 8 if n >= 256 else min(3, n - 1)


def _generate_payload(problem_name: str, size: int, batch: int, seed: int):
    """Host-side generation with the port's generators (float64 on the CPU,
    a ``torch.Generator`` seeded with ``seed``) -> flat dict of numpy arrays,
    the cacheable part; batch-stacked keys carry the ``b_`` prefix."""
    gen = torch.Generator().manual_seed(seed)
    host = dict(dtype=torch.float64, device="cpu")

    if problem_name == "NonnegPCA":
        from riptrm_torch.problems import nonneg_pca

        z = nonneg_pca.generate_instance(gen, size, **host)["Z"].numpy()
        xs0 = np.abs(torch.randn(batch, size, generator=gen, **host).numpy())
        return {"Z": z, "b_xs0": xs0 / np.linalg.norm(xs0, axis=1, keepdims=True)}

    if problem_name == "StableIdentification":
        from riptrm_torch.problems import stable_identification as si

        d = size
        rng = np.random.default_rng(seed)
        _, _, _, true_a = si.generate_true_system(gen, d, **host)
        constset = si.generate_constraints(rng, d, true_a, oneboxratio=0.2, twoboxratio=0.1)
        trajs = [si.generate_trajectory(rng, d, true_a, h=0.02, n_steps=20, snr=10)[1]
                 for _ in range(5)]
        # the scalable target-matching search, every start a lane of one CG
        j, r, q, _ = si.generate_interior_initialpoint_lsq(gen, d, constset, lanes=batch,
                                                           **host)
        return {"trajs": np.stack(trajs), "constset": np.asarray(constset),
                "b_J": j, "b_R": r, "b_Q": q}

    if problem_name == "Rosenbrock":
        from riptrm_torch.problems import rosenbrock

        if size < 2:
            raise ValueError("Rosenbrock needs --size >= 2 (Grassmann(n, k) with k < n has "
                             "dimension k*(n-k) = 0 otherwise)")
        problem = rosenbrock.make_problem(size, _rosenbrock_k(size), **host)
        # small tangent retractions of the reference's start |I[:, :k]|:
        # on the manifold and, at step 5e-3, strictly feasible
        return {"b_xs0": rosenbrock.sweep_starts(problem, gen, batch).numpy()}

    if problem_name == "BoundedPCA":
        from riptrm_torch.problems import bounded_pca

        if size < 3:
            raise ValueError("BoundedPCA needs --size >= 3 (St(n, p) needs n > p >= 2)")
        p = min(max(2, size // 16), size - 1)  # St(n, p) with a small frame
        z = bounded_pca.generate_instance(gen, size, **host)["Z"].numpy()
        starts = [bounded_pca.generate_initialpoint(gen, size, p, **host).numpy()
                  for _ in range(batch)]
        return {"Z": z, "b_xs0": np.stack(starts)}

    if problem_name == "LowRank":
        from riptrm_torch.problems import low_rank

        if size < 5:
            raise ValueError("LowRank needs --size >= 5 (rank must be < min(m, n) for a "
                             "genuine fixed-rank manifold)")
        m, n, rank = size, max(2, size // 2), max(2, size // 8)
        rank = min(rank, n - 1, m - 1)
        a = low_rank.generate_instance(gen, m, n, rank, **host)["A"].numpy()
        starts = [tuple(t.numpy() for t in low_rank.generate_initialpoint(gen, m, n, rank,
                                                                          **host))
                  for _ in range(batch)]
        return {"A": a, "b_U": np.stack([s[0] for s in starts]),
                "b_S": np.stack([s[1] for s in starts]),
                "b_V": np.stack([s[2] for s in starts])}

    raise ValueError("chip_sweep supports NonnegPCA, StableIdentification, Rosenbrock, "
                     f"BoundedPCA and LowRank; got {problem_name}")


PRECISION_FAMILIES = ("NonnegPCA", "StableIdentification")


def _build_from_payload(problem_name: str, size: int, batch: int, payload, *,
                        dtype=torch.float32, device=None, matmul_precision=None):
    """(problem, xs0, ys0) from a (possibly cached) payload; a start of a
    product or fixed-rank manifold is packed into the port's one tensor a
    lane."""
    from riptrm_torch.config import resolve

    dtype, device = resolve(dtype, device)
    kw = dict(dtype=dtype, device=device)
    if matmul_precision is not None and problem_name not in PRECISION_FAMILIES:
        raise ValueError(f"matmul_precision: {problem_name} takes none (only "
                         f"{', '.join(PRECISION_FAMILIES)} do)")
    prec = {} if matmul_precision is None else {"matmul_precision": matmul_precision}

    def tensor(a):
        return torch.as_tensor(np.asarray(a), **kw)

    if problem_name == "NonnegPCA":
        from riptrm_torch.problems import nonneg_pca

        xs0 = tensor(payload["b_xs0"])
        problem = nonneg_pca.make_problem(payload["Z"], xs0[0], **kw, **prec)
    elif problem_name == "StableIdentification":
        from riptrm_torch.problems import stable_identification as si

        starts = (payload["b_J"], payload["b_R"], payload["b_Q"])
        problem = si.make_problem(size, list(payload["trajs"]), payload["constset"],
                                  tuple(a[0] for a in starts), **kw, **prec)
        xs0 = problem.manifold.pack(tuple(tensor(a) for a in starts))
    elif problem_name == "Rosenbrock":
        from riptrm_torch.problems import rosenbrock

        problem = rosenbrock.make_problem(size, _rosenbrock_k(size), **kw)
        xs0 = tensor(payload["b_xs0"])
    elif problem_name == "BoundedPCA":
        from riptrm_torch.problems import bounded_pca

        xs0 = tensor(payload["b_xs0"])
        problem = bounded_pca.make_problem(payload["Z"], xs0[0], **kw)
    elif problem_name == "LowRank":
        from riptrm_torch.problems import low_rank

        starts = (payload["b_U"], payload["b_S"], payload["b_V"])
        problem = low_rank.make_problem(payload["A"], tuple(a[0] for a in starts), **kw)
        xs0 = problem.manifold.pack(tuple(tensor(a) for a in starts))
    else:
        raise ValueError(f"unknown problem family {problem_name}")
    return problem, xs0, torch.ones(batch, problem.num_ineq, **kw)


def _solve_fn(problem, option, max_steps, solver):
    """(xs, ys) -> (final (x, y), steps [B], residuals [B])."""
    from riptrm_torch.parallel.sweep import batched_riptrm_solve, batched_solver_sweep

    if solver == "RIPTRM":
        solve = batched_riptrm_solve(problem, option, max_steps=max_steps)

        def run(xs, ys):
            st, ks, res = solve(xs, ys)
            return (st.x, st.y), ks, res

        return run
    inner = batched_solver_sweep(problem, solver, option, max_steps=max_steps)

    def run(xs, ys):
        x, y, ks, res = inner(xs, ys)
        return (x, y), ks, res

    return run


def measure_sweep(problem, xs0, ys0, option, max_steps, reps=3, solver="RIPTRM",
                  make_solve=None):
    """Wall time of the batched solver sweep, averaged over ``reps`` runs.

    ``make_solve(max_steps) -> run(xs, ys) -> (final, steps, residuals)``
    replaces the solver's own sweep (the staged solve does).  A one-step
    run first pays the one-time costs (library handles, the first launch
    of each kernel); with ``use_fused_tcg`` on the card the kernels are
    built before it.  Each timed run lies between two CUDA
    events (a host clock on the CPU) around a synchronised call.  Returns
    (seconds per sweep, final residuals [B] (numpy), warm-up seconds,
    steps [B] (numpy), final (x, y), hand-written kernel launches in the
    timed runs)."""
    from riptrm_torch.ops import kernels

    cuda = xs0.device.type == "cuda"
    if option.get("use_fused_tcg") and cuda:
        kernels._build.load()

    def sync():
        if cuda:
            torch.cuda.synchronize(xs0.device)

    if make_solve is None:
        make_solve = lambda steps: _solve_fn(problem, option, steps, solver)  # noqa: E731
    warm = make_solve(1)
    sync()
    t0 = time.perf_counter()
    warm(xs0, ys0)
    sync()
    warmup_s = time.perf_counter() - t0

    run = make_solve(max_steps)
    before = kernels.launch_counts()
    times = []
    for _ in range(reps):
        sync()
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            final, ks, res = run(xs0, ys0)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            final, ks, res = run(xs0, ys0)
            times.append(time.perf_counter() - t0)
    after = kernels.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    return (sum(times) / reps, res.cpu().numpy(), warmup_s, ks.cpu().numpy(), final,
            launches)


def _card(device):
    if device.type != "cuda":
        return "cpu"
    from riptrm_torch.utils.devices import name_and_power_limit

    return name_and_power_limit()


def _staged_compact(args, problem, problem_hi, option, option_hi, xs0, ys0, gen_s, source):
    """``--staged-precision --staged-compact``: one warm run (which pays the
    one-time costs of every batch size the instance visits), then ``--reps``
    runs, each timed by the host clock around a synchronised run (phase 2 is
    a host-driven loop), averaged.  Prints and returns the JSON line."""
    from riptrm_torch.ops import kernels
    from riptrm_torch.parallel.sweep import staged_precision_riptrm_compacted

    cuda = xs0.device.type == "cuda"
    if args.fused and cuda:
        kernels._build.load()

    def sync():
        if cuda:
            torch.cuda.synchronize(xs0.device)

    run = staged_precision_riptrm_compacted(problem, problem_hi, option, option_hi,
                                            args.max_steps,
                                            segment_steps=args.staged_segment_steps)
    sync()
    t0 = time.perf_counter()
    run(xs0, ys0)
    sync()
    warmup_s = time.perf_counter() - t0
    before = kernels.launch_counts()
    times = []
    for _ in range(args.reps):
        sync()
        t0 = time.perf_counter()
        best, res1, segs = run(xs0, ys0)
        sync()
        times.append(time.perf_counter() - t0)
    after = kernels.launch_counts()
    per_sweep = sum(times) / args.reps
    out = {
        "problem": args.problem,
        "size": args.size,
        "batch": args.batch,
        "solver": "RIPTRM",
        "mode": "staged_precision_compacted",
        "fused": args.fused,
        "precision": problem.matmul_precision,
        "point": "best",
        "segment_steps": args.staged_segment_steps,
        "solves_per_sec": args.batch / per_sweep,
        "sweep_ms": per_sweep * 1e3,
        "reps": args.reps,
        "median_residual": float(np.median(best)),
        "max_residual": float(np.max(best)),
        "residuals": [float(r) for r in best],
        "phase1_median_residual": float(np.median(res1)),
        "phase1_max_residual": float(np.max(res1)),
        "floor_improvement_x": float(np.median(res1) / max(np.median(best), 1e-30)),
        "segments_used": [int(s) for s in segs],
        "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]},
        "phase2_precision": "highest",
        "staged_tolresid": args.staged_tolresid,
        "gen_s": gen_s,
        "cache": source,
        "warmup_s": warmup_s,
        "device": _card(xs0.device),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--problem", default="NonnegPCA")
    parser.add_argument("--size", type=int, default=1000,
                        help="n for NonnegPCA, d for StableIdentification")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--max-steps", type=int, default=400)
    parser.add_argument("--maxiter", type=int, default=60, help="outer-iteration cap per lane")
    parser.add_argument("--tolresid", type=float, default=3e-4)
    parser.add_argument("--compensated", action="store_true",
                        help="compensated complementarity norm + ared barrier sum "
                             "(ops/compensated.py)")
    parser.add_argument("--fused", action="store_true",
                        help="route tCG through the hand-written kernels (use_fused_tcg; "
                             "sphere_quadratic and stiefel_bound structures: NonnegPCA, "
                             "BoundedPCA)")
    parser.add_argument("--solver", default="RIPTRM", choices=["RIPTRM", "RIPM", "RSQO", "RALM"])
    parser.add_argument("--exact", action="store_true",
                        help="RIPTRM exact mode: per-lane Hw materialization + the exact "
                             "TRS with the in-loop second-order stationarity criterion")
    parser.add_argument("--rsqo-qp-mode", default="reghess_shift",
                        choices=["reghess", "reghess_shift", "reghess_operator", "eye"],
                        help="RSQO Hessian regularization ('reghess' is the reference-exact "
                             "eigenvalue clamp)")
    parser.add_argument("--rsqo-linear-solver", default="schulz",
                        choices=["chol", "lu", "schulz", "schulz_polish"],
                        help="RSQO QP Newton-system solve")
    parser.add_argument("--stall-window", type=int, default=None,
                        help="freeze a sweep lane whose best residual has not improved 1%% "
                             "in this many steps (baseline-solver sweeps)")
    parser.add_argument("--certify", action="store_true",
                        help="post-hoc batched second-order certificates at the final points "
                             "(certify_second_order; RIPTRM, affine constraints only)")
    parser.add_argument("--option", action="append", default=[], metavar="KEY=VALUE",
                        help="extra solver option override, repeatable")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=3, help="timed runs to average")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA device 0; 'cpu' for the CPU)")
    parser.add_argument("--precision", choices=["high", "highest"], default=None,
                        help="the problem's matmul_precision (NonnegPCA, StableIdentification; "
                             "'high' is TF32 on CUDA); default: full float32, and 'high' for "
                             "--staged-precision's phase 1")
    parser.add_argument("--staged-precision", action="store_true",
                        help="two-phase staged precision (RIPTRM, NonnegPCA): phase 1 at "
                             "--precision with the float32 floors, phase 2 continuing every "
                             "lane at 'highest' with 10x tighter floors and --staged-tolresid; "
                             "both phases' residuals reported")
    parser.add_argument("--staged-tolresid", type=float, default=3e-6,
                        help="phase-2 residual target for --staged-precision")
    parser.add_argument("--staged-compact", action="store_true",
                        help="with --staged-precision: phase 2 as host-driven segments over "
                             "the lanes still running, gathered into power-of-two batches "
                             "(staged_precision_riptrm_compacted); timed by the host clock "
                             "around synchronised runs")
    parser.add_argument("--staged-segment-steps", type=int, default=100,
                        help="phase-2 segment length for --staged-compact")
    args = parser.parse_args(argv)
    if args.staged_precision and (args.solver != "RIPTRM" or args.exact
                                  or args.problem != "NonnegPCA"):
        parser.error("--staged-precision is the RIPTRM tCG NonnegPCA floor-chasing mode (phase "
                     "2 rebuilds the problem at matmul_precision='highest')")
    precision = args.precision or ("high" if args.staged_precision else None)
    if precision is not None and args.problem not in PRECISION_FAMILIES:
        parser.error(f"--precision applies to {', '.join(PRECISION_FAMILIES)} (the families "
                     "with a matmul_precision)")
    if args.certify and (args.solver != "RIPTRM" or args.problem == "StableIdentification"):
        parser.error("--certify needs RIPTRM final states and affine constraints "
                     "(StableIdentification's annulus terminal duals make any terminal "
                     "curvature bound vacuous)")
    if args.exact and args.fused:
        parser.error("--fused applies to the tCG subproblem only; the exact mode solves the "
                     "TRS by eigendecomposition (no kernel to route to)")
    if args.exact and args.solver != "RIPTRM":
        parser.error("--exact selects RIPTRM's Exact_RepMat mode; the baseline solvers "
                     "ignore those options")

    from riptrm_torch.config import resolve
    from riptrm_torch.experiment.protocol_speedrun import parse_option

    dtype, device = resolve(torch.float32, args.device)  # raises without CUDA
    t0 = time.perf_counter()
    _, source = _cache_load(args.problem, args.size, args.batch, args.seed)
    problem, xs0, ys0 = build_sweep(args.problem, args.size, args.batch, args.seed,
                                    dtype=dtype, device=device, matmul_precision=precision)
    gen_s = time.perf_counter() - t0

    # float32 forcing floors.  The complementarity criterion is a 2-norm
    # over all m constraints, so its reachable floor grows like sqrt(m);
    # 2e-4 was calibrated at m = 200 (NonnegPCA n = 200).
    compl_floor = 2e-4 * max(1.0, (problem.num_ineq / 200.0) ** 0.5)
    option = {
        "maxiter": args.maxiter,
        "tolresid": args.tolresid,
        "TRS_solver": "Exact_RepMat" if args.exact else "tCG",
        "second_order_stationarity": args.exact,
        "use_fused_tcg": args.fused,
        "compensated_reductions": args.compensated,
        "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
        "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=compl_floor),
    }
    if args.exact:
        option["forcing_function_second_order"] = lambda mu: torch.clamp(mu, min=1e-4)
    if args.solver == "RSQO":
        option["quadoptim_type"] = args.rsqo_qp_mode
        option["quadoptim_linear_solver"] = args.rsqo_linear_solver
    if args.stall_window is not None:
        option["sweep_stall_window"] = args.stall_window
    option.update(parse_option(kv) for kv in args.option)

    make_solve, staged_res1 = None, []
    if args.staged_precision:
        from riptrm_torch.parallel.sweep import staged_precision_riptrm_solve

        # Phase 2: the same problem at 'highest', floors 10x lower, and a
        # stall guard so that floored lanes do not hold the lockstep budget.
        problem_hi = dataclasses.replace(problem, matmul_precision="highest")
        compl_floor_hi = compl_floor / 10.0
        option_hi = option | {
            "tolresid": args.staged_tolresid,
            "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-5),
            "forcing_function_complementarity":
                lambda mu: torch.clamp(1e-3 * mu, min=compl_floor_hi),
            "sweep_stall_window": option.get("sweep_stall_window", 25),
        }

        if args.staged_compact:
            return _staged_compact(args, problem, problem_hi, option, option_hi, xs0, ys0,
                                   gen_s, source)

        def make_solve(steps):
            staged = staged_precision_riptrm_solve(problem, problem_hi, option, option_hi,
                                                   steps)

            def run(xs, ys):
                st, ks, res2, res1 = staged(xs, ys)
                staged_res1[:] = [res1]  # the last run's phase-1 residuals
                return (st.x, st.y), ks, res2

            return run

    per_sweep, res, warmup_s, steps, final, launches = measure_sweep(
        problem, xs0, ys0, option, max_steps=args.max_steps, reps=args.reps,
        solver=args.solver, make_solve=make_solve)
    card = _card(device)
    out = {
        "problem": args.problem,
        "size": args.size,
        "batch": args.batch,
        "solver": args.solver,
        "mode": ("staged_precision" if args.staged_precision
                 else "exact" if args.exact else "tCG"),
        "fused": args.fused,
        "precision": precision,
        # which iterate the residuals score: RALM and the staged
        # continuation default to their best one
        "point": ("best" if args.staged_precision
                  or option.get("keep_best_point", args.solver == "RALM") else "final"),
        **({"rsqo_linear_solver": args.rsqo_linear_solver} if args.solver == "RSQO" else {}),
        "solves_per_sec": args.batch / per_sweep,
        "sweep_ms": per_sweep * 1e3,
        "reps": args.reps,
        "median_residual": float(np.median(res)),
        "max_residual": float(np.max(res)),
        "residuals": [float(r) for r in res],
        "mean_steps": float(np.mean(steps)),
        "max_steps_taken": int(np.max(steps)),
        "launches": {k: v for k, v in launches.items() if v},
        "gen_s": gen_s,
        "cache": source,
        "warmup_s": warmup_s,
        "device": card,
    }
    if args.staged_precision:
        res1 = staged_res1[0].cpu().numpy()
        out |= {
            "phase2_precision": "highest",
            "staged_tolresid": args.staged_tolresid,
            "phase1_median_residual": float(np.median(res1)),
            "phase1_max_residual": float(np.max(res1)),
            "phase1_residuals": [float(r) for r in res1],
            "floor_improvement_x": float(np.median(res1) / max(np.median(res), 1e-30)),
            "lanes_above_phase1": int(np.sum(res > res1)),
        }
    if args.certify:
        from riptrm_torch.parallel.sweep import certify_second_order

        x, y = final
        t0 = time.perf_counter()
        mineigs = certify_second_order(problem, x, y, ratio_cap=1e8).cpu().numpy()
        out["certify_s"] = time.perf_counter() - t0
        out["certified_mineig_min"] = float(np.nanmin(mineigs))
        out["certified_mineig_median"] = float(np.nanmedian(mineigs))
        out["certified_lanes"] = int(np.isfinite(mineigs).sum())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

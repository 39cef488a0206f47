"""Weak-scaling harness of the sharded multi-start sweep.

Counterpart of ``riptrm_tpu/experiment/scaling.py``.  The measured quantity
is the throughput of batched multi-start RIPTRM solves (the reference's
multirun sweep axes) split over a dp mesh axis of ``torch.distributed``
ranks (``parallel/sweep.py::sharded_riptrm_solve``).  Weak scaling: the
per-rank batch is fixed and the rank count grows, so ideal scaling is
throughput proportional to ranks:

    efficiency(d) = solves_per_sec(d) / (d * solves_per_sec(1))

Timing: every rank runs the sharded sweep once to warm up, then ``tries``
times, each run after a barrier and between two CUDA events (the host
clock on the CPU); the rate is the batch over the median run, rank 0's.
This replaces the JAX module's marginal-rate scan, which cancels a remote
TPU's fetch latency that a local card does not have.

``measure`` starts a world of d processes for each rank count d (the
workers of ``parallel/dryrun.py``, task ``scaling``).  Ranks on fewer
cards than ranks share a device (gloo, since NCCL refuses that): their row
has ``"efficiency": null`` and ``"shared_device": true``, because d
processes on one card are not weak scaling.  On the CPU every rank shares
the host.

    python -m riptrm_torch.experiment.scaling                 # d = 1, 2, 4, ... cards
    python -m riptrm_torch.experiment.scaling --device cpu --ranks 1,2
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

import torch

N, PER_RANK, MAX_STEPS, TRIES = 256, 4, 200, 5


def make_instance(n: int, dtype=torch.float32, device=None):
    """The harness's NonnegPCA instance of size n, from seed 0 on the
    host, the same on every rank."""
    from riptrm_torch.problems import nonneg_pca

    gen = torch.Generator().manual_seed(0)
    z = nonneg_pca.generate_instance(gen, n, dtype=torch.float64, device="cpu")["Z"]
    x0 = torch.abs(torch.randn(n, generator=gen, dtype=torch.float64))
    return nonneg_pca.make_problem(z, x0 / torch.linalg.vector_norm(x0), dtype=dtype,
                                   device=device)


def option() -> dict:
    """The JAX harness's options: float32 forcing floors."""
    return {
        "maxiter": 60,
        "tolresid": 3e-4,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
        "forcing_function_Lagrangian": lambda mu: torch.clamp(mu, min=1e-4),
        "forcing_function_complementarity": lambda mu: torch.clamp(1e-3 * mu, min=2e-4),
    }


def starts(problem, batch):
    """The sweep's starts (xs0 [batch, n], ys0 [batch, m]), from seed 11 on
    the host, the same on every rank."""
    like = problem.y0
    gen = torch.Generator().manual_seed(11)
    xs0 = torch.abs(torch.randn(batch, problem.manifold.n, generator=gen))
    xs0 = (xs0 / torch.linalg.vector_norm(xs0, dim=-1, keepdim=True)).to(like)
    return xs0, torch.ones(batch, problem.num_ineq, dtype=like.dtype, device=like.device)


def sweep_rate(problem, option, mesh, batch, max_steps, tries=TRIES):
    """Throughput (solves/s) of the sharded multi-start sweep of ``batch``
    lanes (from ``starts``) over ``mesh``'s dp axis, on every rank of the
    mesh.  Returns (solves_per_sec, median_residual, max_residual)."""
    from riptrm_torch.parallel import distributed
    from riptrm_torch.parallel.sweep import sharded_riptrm_solve

    xs0, ys0 = starts(problem, batch)
    fn = sharded_riptrm_solve(problem, option, max_steps, mesh)
    res = fn(xs0, ys0)[3]  # warm-up
    cuda = ys0.is_cuda
    times = []
    for _ in range(tries):
        distributed.barrier()
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = fn(xs0, ys0)[3]
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            res = fn(xs0, ys0)[3]
            times.append(time.perf_counter() - t0)
    return batch / statistics.median(times), float(res.median()), float(res.max())


def measure(rank_counts, per_rank=PER_RANK, n=N, max_steps=MAX_STEPS, tries=TRIES,
            device=None, dtype="float32"):
    """Weak-scaling rows, one world of d processes for each d of
    ``rank_counts``, each solving ``make_instance(n)`` in ``dtype`` from
    ``starts``: {ranks, batch, backend, shared_device, solves_per_sec,
    efficiency, median_residual, max_residual, device}.  The efficiency is
    relative to the first row, and null where ranks share a device."""
    from riptrm_torch.parallel import dryrun

    cpu = device is not None and torch.device(device).type == "cpu"
    cards = 0 if cpu else torch.cuda.device_count()
    name = "cpu" if cpu else torch.cuda.get_device_name(0)
    rows, base = [], None
    for d in rank_counts:
        shared = d > 1 and (cpu or d > cards)
        backend = "gloo" if cpu or shared else "nccl"
        with tempfile.TemporaryDirectory(prefix="riptrm_scaling_") as tmp:
            out = dryrun.run_tasks(d, [("scaling", {"n": n, "batch": per_rank * d,
                                                    "max_steps": max_steps, "tries": tries,
                                                    "dtype": dtype})],
                                   tmp, device=device, backend=backend)[0]
        rate = float(out["scaling.rate"])
        if base is None:
            base = (rate, d)
        rows.append({
            "device": name,
            "ranks": d,
            "batch": per_rank * d,
            "backend": backend,
            "shared_device": shared,
            "solves_per_sec": rate,
            "efficiency": None if shared else rate / (base[0] * d / base[1]),
            "median_residual": float(out["scaling.median"]),
            "max_residual": float(out["scaling.max"]),
        })
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n", type=int, default=N)
    parser.add_argument("--per-rank", type=int, default=PER_RANK)
    parser.add_argument("--max-steps", type=int, default=MAX_STEPS)
    parser.add_argument("--tries", type=int, default=TRIES)
    parser.add_argument("--ranks", default=None,
                        help="comma-separated rank counts (default 1, 2, 4, ... up to the "
                             "card count)")
    parser.add_argument("--device", default=None, help="'cpu'; default CUDA")
    parser.add_argument("--out", default=None, help="write the rows as JSON here")
    args = parser.parse_args(argv)
    if args.ranks is not None:
        counts = [int(d) for d in args.ranks.split(",")]
    else:
        from riptrm_torch.utils.devices import cuda_device

        cuda_device()  # raises without CUDA
        counts = [1 << k for k in range(torch.cuda.device_count().bit_length())]
    rows = measure(counts, args.per_rank, args.n, args.max_steps, args.tries, args.device)
    for row in rows:
        print(json.dumps(row))
    if args.device is None and torch.cuda.device_count() < 2:
        print("d >= 2: not measured (one card)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

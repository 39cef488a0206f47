"""Multi-process dry run of the port's scale-out, and the worker of its
multi-process runs.

    python -m riptrm_torch.parallel.dryrun --world 2 --backend gloo
    python -m riptrm_torch.parallel.dryrun --world 2 --device cpu

Counterpart of ``__graft_entry__.py::dryrun_multichip``.  Spawns ``--world``
W processes joined by ``torch.distributed`` (a ``file://`` rendezvous in a
fresh temporary directory), each of which runs, in float32:

1. NonnegPCA n = 256 over a dp x tp mesh (tp = 2 where W is even): Zs's
   rows split over tp, 4 lanes a dp rank, the plain tCG, 250 steps
   (``sharded_riptrm_solve``): every lane at the option's tolerance, as in
   the unsharded solve of the same lanes; and one step from the first start
   against the unsharded step (x within rtol 2e-4, atol 2e-5; the residual
   within rtol 1e-3);
2. ``sharded_riptrm_solve`` over a dp mesh of all W ranks, 2 lanes a rank,
   25 steps: the all-gathered residuals finite, [2W], and equal on every
   rank;
3. StableIdentification d = 8 with its trajectory columns split over all W
   ranks: one step against the unsharded step (residual within rtol 1e-3).

The data comes from seeds on the host, the same on every rank.  NCCL
refuses two ranks on one card: on one card pass ``--backend gloo``.  Runs
on CUDA unless ``--device cpu``; exits non-zero if any rank fails.

The same module is the worker of the port's other multi-process runs
(``run_tasks``, which the tests, ``chip_smoke.py`` and
``experiment/scaling.py`` call): ``--spec FILE --out DIR`` runs the tasks
of ``TASKS`` that FILE lists with their JSON parameters, in order, on every
rank, and rank r writes its results to ``DIR/rank<r>.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER_TIMEOUT = 120.0  # seconds a worker may take, each


class WorkerFailure(RuntimeError):
    pass


def spawn(world: int, args, timeout: float = WORKER_TIMEOUT):
    """Run ``world`` worker processes of this module with ``args`` (the
    task's arguments) as the ranks of one group.  Each worker has
    ``timeout`` seconds; past it, or once a worker fails (its peers would
    wait for it in a collective), every worker left is killed.  Returns
    [(returncode, stdout, stderr)] in rank order; raises
    ``WorkerFailure`` past the timeout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="riptrm_dryrun_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        logs = [(open(os.path.join(tmp, f"{r}.out"), "w+"),
                 open(os.path.join(tmp, f"{r}.err"), "w+")) for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "riptrm_torch.parallel.dryrun", "--rank", str(r),
             "--world", str(world), "--init", init, *args],
            stdout=out, stderr=err, text=True, env=env) for r, (out, err) in enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise WorkerFailure(f"a worker of {world} ran past {timeout} s")
                time.sleep(0.05)
        finally:  # a failed or timed-out run leaves no worker behind
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        result = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            result.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
    return result


# ----------------------------------------------------------------------
# Tasks: each runs on every rank and returns {name: array-like}
# ----------------------------------------------------------------------
def _floors(option: dict) -> dict:
    """The option with the float32 forcing floors of bench.py, given as
    ``floors: [Lagrangian, complementarity]`` in a JSON spec."""
    option = dict(option)
    lag, compl = option.pop("floors", (None, None))
    if lag is not None:
        option["forcing_function_Lagrangian"] = lambda mu: torch.clamp(mu, min=lag)
        option["forcing_function_complementarity"] = (
            lambda mu: torch.clamp(1e-3 * mu, min=compl))
    return option


def _nonneg_inputs(spec, kw, mesh=None, axis="tp"):
    """(problem, xs0, ys0) from ``spec['inputs']``, an npz of Z [n, n],
    xs [B, n] and ys [B, n]; with ``mesh``, Zs's rows split over its axis
    ``axis``."""
    from riptrm_torch.problems import nonneg_pca

    with np.load(spec["inputs"]) as data:
        z, xs, ys = (torch.as_tensor(data[k], **kw) for k in ("Z", "xs", "ys"))
    return nonneg_pca.make_problem(z, xs[0], **kw, mesh=mesh, axis=axis), xs, ys


def _staging_copies(t, group):
    """(device-to-host, host-to-device) copies in ``torch.profiler``'s trace
    of one ``all_gather_cat`` of ``t`` over ``group``: how a backend moves
    CUDA tensors.  (-1, -1), not measured, off CUDA or where the trace
    holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    from riptrm_torch.ops import collectives

    if not t.is_cuda:
        return -1, -1
    torch.cuda.synchronize(t.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        collectives.all_gather_cat(t, group)
        torch.cuda.synchronize(t.device)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return -1, -1
    return (sum(n.startswith("Memcpy DtoH") for n in names),
            sum(n.startswith("Memcpy HtoD") for n in names))


def task_sweep(ctx, spec):
    """``run_sweep`` over a dp mesh of every rank (``sharded_riptrm_solve``
    with every result gathered), its seconds after a one-step warm-up and
    the kernels' launches in it on this rank, ``host_shard`` of 7 jobs,
    and the host copies of one all-gather of the residuals
    (``_staging_copies``)."""
    from riptrm_torch.ops import collectives, kernels
    from riptrm_torch.parallel import distributed, sweep

    problem, xs, ys = _nonneg_inputs(spec, ctx.kw)
    mesh = sweep.make_mesh({"dp": ctx.world}, ctx.device)
    option = _floors(spec["option"])
    # one step first: the process's first CUDA work and the collectives'
    # set-up are not timed
    sweep.run_sweep(problem, option, xs, ys, max_steps=1, mesh=mesh)
    kernels.reset_launch_counts()
    distributed.barrier()
    t0 = _clock(ctx.device)
    x, y, ks, res = sweep.run_sweep(problem, option, xs, ys, max_steps=spec["max_steps"],
                                    mesh=mesh)
    seconds = _clock(ctx.device) - t0
    launches = {f"launches.{k}": v for k, v in kernels.launch_counts().items()}
    dtoh, htod = _staging_copies(res, collectives.mesh_axis(mesh, "dp")[0])
    return {"x": x, "y": y, "ks": ks, "res": res, "seconds": seconds,
            "host_shard": distributed.host_shard(list(range(7))),
            "staging_dtoh": dtoh, "staging_htod": htod, **launches}


def task_nonneg_tp(ctx, spec):
    """NonnegPCA with Zs's rows split over a tp mesh axis of every rank
    (dp = 1), the fused tCG asked for: ``run_sweep`` of every lane, one
    RIPTRM step from lane 0's start, whether the problem carries a
    structure, and the kernels' launches in all of it."""
    from riptrm_torch.ops import kernels
    from riptrm_torch.parallel import sweep
    from riptrm_torch.solvers.riptrm import RIPTRM, make_step

    kernels.reset_launch_counts()
    mesh = sweep.make_mesh({"dp": 1, "tp": ctx.world}, ctx.device)
    problem, xs, ys = _nonneg_inputs(spec, ctx.kw, mesh=mesh, axis="tp")
    option = _floors(spec["option"]) | {"use_fused_tcg": True}
    x, _, ks, res = sweep.run_sweep(problem, option, xs, ys, max_steps=spec["max_steps"],
                                    mesh=mesh)
    opt = RIPTRM(option).option
    st, info = make_step(problem, opt)(sweep.init_state_from(problem, opt, xs[:1], ys[:1]))
    return {"x": x, "ks": ks, "res": res, "step_x": st.x[0],
            "step_residual": info["residual"][0], "structured": problem.structure is not None,
            **{f"launches.{k}": v for k, v in kernels.launch_counts().items()}}


class _Kill(Exception):
    pass


def task_checkpoint(ctx, spec):
    """``run_sweep_checkpointed`` over a dp mesh of every rank into
    ``spec['path']``; with ``kill_after`` k, killed after segment k on every
    rank (``killed`` 1, the results empty)."""
    from riptrm_torch.parallel import sweep

    problem, xs, ys = _nonneg_inputs(spec, ctx.kw)
    mesh = sweep.make_mesh({"dp": ctx.world}, ctx.device)
    kill = spec.get("kill_after")

    def on_segment(n_seg, steps, res, done):
        if n_seg == kill:
            raise _Kill

    try:
        x, y, ks, res = sweep.run_sweep_checkpointed(
            problem, _floors(spec["option"]), xs, ys, max_steps=spec["max_steps"],
            segment_steps=spec["segment_steps"], checkpoint_path=spec["path"], mesh=mesh,
            on_segment=on_segment)
    except _Kill:
        return {"killed": 1}
    return {"killed": 0, "x": x, "y": y, "ks": ks, "res": res}


def _sid_problem(spec, kw, mesh=None, axis="tp"):
    """StableIdentification from ``spec['dataset']``, an npz of ``trajs``
    [T, d, N], ``constset``, the start's ``J``, ``R`` and ``Q`` and, where it
    has one, ``y0``."""
    from riptrm_torch.problems import stable_identification as si

    with np.load(spec["dataset"]) as data:
        trajs, constset = list(data["trajs"]), data["constset"]
        x0 = (data["J"], data["R"], data["Q"])
        y0 = data["y0"] if "y0" in data.files else None
    return si.make_problem(trajs[0].shape[0], trajs, constset, x0, y0, mesh=mesh,
                           data_axis=axis, **kw)


def _sid_steps(sharded, plain, option, warm=False):
    """((residual [B], seconds) of one RIPTRM step from the start) of the
    data-sharded and of the unsharded problem; with ``warm``, each step
    timed after a first one."""
    from riptrm_torch.solvers.riptrm import RIPTRM, init_state, make_step

    opt = RIPTRM(option).option
    out = []
    for p in (sharded, plain):
        step, st0 = make_step(p, opt), init_state(p, opt)
        if warm:
            step(st0)
        t0 = _clock(p.y0.device)
        res = step(st0)[1]["residual"]
        out.append((res, _clock(p.y0.device) - t0))
    return out


def _clock(device):
    """The host clock after the device's queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def task_sid_step(ctx, spec):
    """One RIPTRM step of a StableIdentification instance with its
    trajectory columns split over a data mesh of every rank, and of the
    unsharded instance (each timed after a first step), their costs at
    the start, and the kernels' launches in all of it."""
    from riptrm_torch.ops import kernels
    from riptrm_torch.parallel import sweep

    kernels.reset_launch_counts()
    mesh = sweep.make_mesh({"data": ctx.world}, ctx.device)
    sharded = _sid_problem(spec, ctx.kw, mesh=mesh, axis="data")
    plain = _sid_problem(spec, ctx.kw)
    x0 = plain.x0[None]
    (r_sh, t_sh), (r_un, t_un) = _sid_steps(sharded, plain, _floors(spec["option"]),
                                            warm=True)
    return {"residual": r_sh[0], "residual_plain": r_un[0], "seconds": t_sh,
            "seconds_plain": t_un, "cost": sharded.cost(x0)[0], "cost_plain": plain.cost(x0)[0],
            **{f"launches.{k}": v for k, v in kernels.launch_counts().items()}}


def task_materialize(ctx, spec):
    """``materialize_sharded`` of the Lagrangian's Hessian of a
    StableIdentification instance at its start, over a tp mesh of every
    rank, and this rank's ``materialize`` of the same operator."""
    from riptrm_torch.ops.basis import materialize, materialize_sharded
    from riptrm_torch.parallel import sweep

    problem = _sid_problem(spec, ctx.kw)
    man, x = problem.manifold, problem.x0[None]
    basis = man.basis(x)
    op = problem.lag_rhess_at(x, problem.y0[None])
    mesh = sweep.make_mesh({"tp": ctx.world}, ctx.device)
    return {"sharded": materialize_sharded(man, x, basis, op, mesh, axis="tp")[0],
            "dense": materialize(man, x, basis, op)[0]}


def task_stableid(ctx, spec):
    """The fixed-budget RIPTRM solve of a StableIdentification instance
    with its trajectory columns split over a tp mesh of every rank."""
    from riptrm_torch.ops.kkt import compute_residual
    from riptrm_torch.parallel import sweep
    from riptrm_torch.solvers.riptrm import RIPTRM, init_state

    mesh = sweep.make_mesh({"tp": ctx.world}, ctx.device)
    problem = _sid_problem(spec, ctx.kw, mesh=mesh, axis="tp")
    solver = RIPTRM(spec["option"])
    st, k = solver.solve_compiled(problem, spec["max_steps"])(init_state(problem, solver.option))
    return {"x": st.x[0], "steps": k[0], "residual": compute_residual(problem, st.x, st.y)[0][0],
            "cost": problem.cost(st.x)[0]}


def task_scaling(ctx, spec):
    """``experiment/scaling.py::sweep_rate`` over a dp mesh of every rank."""
    from riptrm_torch.experiment import scaling
    from riptrm_torch.parallel import sweep

    problem = scaling.make_instance(spec["n"], **ctx.kw)
    mesh = sweep.make_mesh({"dp": ctx.world}, ctx.device)
    rate, med, mx = scaling.sweep_rate(problem, scaling.option(), mesh, spec["batch"],
                                       spec["max_steps"], tries=spec["tries"])
    return {"rate": rate, "median": med, "max": mx}


def task_dryrun(ctx, spec):
    """The dry run of the module's docstring; raises on a failed check."""
    from riptrm_torch.ops import collectives, kernels
    from riptrm_torch.parallel import distributed, sweep
    from riptrm_torch.problems import nonneg_pca
    from riptrm_torch.problems import stable_identification as si
    from riptrm_torch.solvers.riptrm import RIPTRM, make_step

    kw, world = ctx.kw, ctx.world
    kernels.reset_launch_counts()
    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = sweep.make_mesh({"dp": dp, "tp": tp}, ctx.device)
    n, batch = 256, 4 * dp
    gen = torch.Generator().manual_seed(0)
    z = nonneg_pca.generate_instance(gen, n, dtype=torch.float32, device="cpu")["Z"]
    xs0 = torch.abs(torch.randn(batch, n, generator=gen))
    xs0 = (xs0 / torch.linalg.vector_norm(xs0, dim=-1, keepdim=True)).to(**kw)
    ys0 = torch.ones(batch, n, **kw)
    problem = nonneg_pca.make_problem(z, xs0[0], **kw, mesh=mesh, axis="tp")
    plain = nonneg_pca.make_problem(z, xs0[0], **kw)
    option = _floors({"maxiter": 30, "tolresid": 5e-3, "TRS_solver": "tCG",
                      "second_order_stationarity": False, "floors": [1e-4, 2e-4]})
    tol = option["tolresid"]
    x, _, ks, res = sweep.sharded_riptrm_solve(problem, option, 250, mesh, "dp")(xs0, ys0)
    mine = collectives.shard_range(batch, dp, collectives.mesh_axis(mesh, "dp")[2], "lanes")
    _, _, res_plain = sweep.batched_riptrm_solve(plain, option, 250)(xs0[mine], ys0[mine])
    _check(bool(torch.isfinite(x).all()) and bool((ks > 0).all()), "dp x tp solve not finite")
    _check(bool((res <= tol).all()), f"dp x tp solve missed {tol}: {res.tolist()}")
    _check(bool((res_plain <= tol).all()), f"unsharded solve missed {tol}: {res_plain.tolist()}")
    opt = RIPTRM(option).option
    st0 = sweep.init_state_from(problem, opt, xs0[:1], ys0[:1])
    st_sh, info_sh = make_step(problem, opt)(st0)
    st_un, info_un = make_step(plain, opt)(st0)
    step_x = float(torch.max(torch.abs(st_sh.x - st_un.x)))
    _check(bool(torch.allclose(st_sh.x, st_un.x, rtol=2e-4, atol=2e-5)),
           f"one tp-sharded step differs from the unsharded one by {step_x}")
    _check(bool(torch.allclose(info_sh["residual"], info_un["residual"], rtol=1e-3)),
           "one tp-sharded step's residual differs from the unsharded one's")

    dp_mesh = sweep.make_mesh({"dp": world}, ctx.device)
    g7 = torch.Generator().manual_seed(7)
    xs_dp = torch.abs(torch.randn(2 * world, n, generator=g7))
    xs_dp = (xs_dp / torch.linalg.vector_norm(xs_dp, dim=-1, keepdim=True)).to(**kw)
    _, _, _, res_all = sweep.sharded_riptrm_solve(plain, option, 25, dp_mesh)(
        xs_dp, torch.ones(2 * world, n, **kw))
    _check(tuple(res_all.shape) == (2 * world,) and bool(torch.isfinite(res_all).all()),
           f"gathered residuals {tuple(res_all.shape)} not finite")
    every = collectives.all_gather_cat(res_all[None], collectives.mesh_axis(dp_mesh, "dp")[0])
    _check(bool((every == res_all).all()), "the gathered residuals differ between ranks")

    d = 8
    rng = np.random.default_rng(0)
    gen3 = torch.Generator().manual_seed(3)
    host = dict(dtype=torch.float64, device="cpu")
    _, _, _, true_a = si.generate_true_system(gen3, d, **host)
    constset = si.generate_constraints(rng, d, true_a, 0.2, 0.1)
    trajs = [si.generate_trajectory(rng, d, true_a, h=0.02, n_steps=4 * world, snr=10)[1]
             for _ in range(2)]
    j0, r0, q0, _ = si.generate_interior_initialpoint_lsq(
        torch.Generator().manual_seed(4), d, constset, cg_iters=200, **host)
    data_mesh = sweep.make_mesh({"data": world}, ctx.device)
    sid = si.make_problem(d, trajs, constset, (j0, r0, q0), mesh=data_mesh, data_axis="data",
                          **kw)
    sid_plain = si.make_problem(d, trajs, constset, (j0, r0, q0), **kw)
    r_sh, r_un = (float(r[0]) for r, _ in _sid_steps(sid, sid_plain, option))
    _check(np.isfinite(r_sh) and abs(r_sh - r_un) <= 1e-3 * abs(r_un),
           f"data-sharded StableIdentification step residual {r_sh}, unsharded {r_un}")
    return {"res": res, "res_plain": res_plain, "step_x_diff": step_x, "res_all": res_all,
            "sid_residual": r_sh, "sid_residual_plain": r_un,
            **{f"launches.{k}": v for k, v in kernels.launch_counts().items()}}


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


TASKS = {"dryrun": task_dryrun, "sweep": task_sweep, "nonneg_tp": task_nonneg_tp,
         "checkpoint": task_checkpoint, "sid_step": task_sid_step,
         "materialize": task_materialize, "stableid": task_stableid, "scaling": task_scaling}


class _Context:
    def __init__(self, world, device):
        self.world, self.device = world, device
        self.kw = dict(dtype=torch.float32, device=device)


def worker(args) -> int:
    """One rank: join the group, run the tasks in order, write their
    results (``<label>.<key>``, the label a task's parameters give, else
    its name) to ``<out>/rank<r>.npz``."""
    import torch.distributed as dist

    from riptrm_torch.parallel import distributed

    if args.device == "cpu":
        torch.set_num_threads(1)  # the CPU's batched LU hangs with more threads
    device = distributed.initialize(args.init, args.world, args.rank, backend=args.backend,
                                    device=args.device)
    tasks = [["dryrun", {}]]
    if args.spec:
        with open(args.spec) as f:
            tasks = json.load(f)
    ctx = _Context(args.world, device)
    out = {}
    try:
        for name, params in tasks:
            ctx.kw["dtype"] = getattr(torch, params.get("dtype", "float32"))
            label = params.get("label", name)
            t0 = _clock(device)
            results = TASKS[name](ctx, params)
            out[f"{label}.seconds_task"] = np.asarray(_clock(device) - t0)
            for key, value in results.items():
                out[f"{label}.{key}"] = (value.detach().cpu().numpy()
                                        if isinstance(value, torch.Tensor) else np.asarray(value))
        distributed.barrier()
    finally:
        dist.destroy_process_group()
    if args.out:
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    print(json.dumps({"rank": args.rank, **{k: v.tolist() for k, v in out.items()
                                           if v.size <= 16}}), flush=True)
    return 0


def run_tasks(world: int, tasks, out_dir: str, *, device=None, backend=None,
              timeout: float = WORKER_TIMEOUT):
    """``spawn`` ``world`` workers that run ``tasks``, a list of (name of a
    task of ``TASKS``, its JSON parameters, with ``dtype``, default
    float32, and ``label``, default the name), in order; returns every
    rank's results ({``<label>.<key>``: array}) in rank order, and raises
    ``WorkerFailure`` with the failing rank's stderr if a rank fails."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "tasks.json")
    with open(spec, "w") as f:
        json.dump([[name, params] for name, params in tasks], f)
    args = ["--spec", spec, "--out", out_dir]
    args += [] if device is None else ["--device", str(device)]
    args += [] if backend is None else ["--backend", backend]
    outs = spawn(world, args, timeout)
    failed = [(rc < 0, r) for r, (rc, _, _) in enumerate(outs) if rc != 0]
    if failed:  # the rank that failed, before the ranks killed after it
        r = min(failed)[1]
        raise WorkerFailure(f"rank {r} of {world} exited {outs[r][0]}:\n{outs[r][2][-4000:]}")
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as data:
            results.append({k: data[k] for k in data.files})
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--world", type=int, default=2, help="the number of processes")
    parser.add_argument("--device", default=None, help="'cpu' (gloo); default CUDA")
    parser.add_argument("--backend", default=None, help="'gloo' or 'nccl' (default: "
                        "NCCL on CUDA, gloo on the CPU)")
    parser.add_argument("--spec", default=None, help="a JSON list of [task, parameters] "
                        "(default: the dry run)")
    parser.add_argument("--out", default=None, help="directory of the ranks' results")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return worker(args)
    outs = spawn(args.world, sys.argv[1:] if argv is None else list(argv))
    for r, (rc, out, err) in enumerate(outs):
        print(f"rank {r}: exit {rc}")
        print(out.strip())
        if rc != 0:
            print(err[-4000:], file=sys.stderr)
    ok = all(rc == 0 for rc, _, _ in outs)
    print(f"dryrun {'passed' if ok else 'FAILED'} at world size {args.world}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

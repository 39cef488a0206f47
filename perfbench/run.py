"""The benchmark of riptrm_torch on an NVIDIA GPU: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m perfbench.run`` runs the same.)  Run from the root of a
checkout.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison with the
reference judged, beside its limit (also the last lines of standard
error).  Without a CUDA device, or with fewer than the cell asks for, the
run exits with 2 and prints no result; so it does if the port or the
benchmark's own files are missing.

``--control`` runs the cell's lower-precision control (the program's TF32
path switched on and, where the cell compares the tCG step, the kernel
replaced by the reference's tCG in TF32), the control that the limits of
``correct`` were set against; it should come out not correct.
``--rehearse`` (CPU tests only) runs on the CPU and reports no metric.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every cache the program or torch could write lives at a fixed path inside
# the checkout (the kernels' own build cache is riptrm_torch/_build/), and
# the host side runs one thread of its own, for steady timing.
CACHE = ROOT / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
PINNED_CORES = 2


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def steady_host(torch):
    """One intra-op and one inter-op thread, and the process on the last
    ``PINNED_CORES`` of the cores it may use (the host's dispatch thread
    and the CUDA driver's own threads), so that the scheduler does not
    move the dispatching thread between cores."""
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-PINNED_CORES:])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=[0, 1], default=0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--rehearse", action="store_true")
    args = parser.parse_args(argv)

    try:
        from perfbench import harness
        cell = harness.find_cell(args.workload)
        import torch
        import riptrm_torch  # noqa: F401  the program under test
    except (ImportError, OSError, KeyError) as e:
        fail(f"cannot load the cell or the program: {e!r}")
    steady_host(torch)

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            fail("CUDA is not available: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell.chips:
            fail(f"{cell.name} needs {cell.chips} CUDA devices, "
                 f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)

    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device=device, t_process0=T_PROCESS0,
                              control=args.control, rehearse=args.rehearse)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules loaded that the benchmark must not load: {', '.join(found)}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_json_safe(result), allow_nan=False), flush=True)


def _json_safe(value):
    """``value`` with every non-finite float written as a string ("inf",
    "nan"): JSON has no such numbers."""
    if isinstance(value, dict):
        return {k: _json_safe(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_json_safe(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


if __name__ == "__main__":
    main()

"""Build and load the CUDA kernels of ``riptrm_torch/csrc``.

At first use ``nvcc`` compiles every ``csrc/*.cu`` (one process per
source, all started together) and links them into one shared library with
a plain C interface, ``riptrm_torch/_build/kernels_<hash>.so``, keyed by a
hash of the sources (``*.cuh`` included) and the flags, and ``ctypes``
loads it.
Pointers and the stream are passed as ``c_void_p``, ints as ``c_int``.
This takes seconds, where a build that includes PyTorch's headers takes
minutes.  Nothing here runs at import time; a missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # zs, x, w, v0, u scratch, out, n, n_iters, grid, rows_per_cta, device,
    # stream
    "chain_resident_launch": [_P] * 6 + [_I] * 5 + [_P],
    # zs, xs, ws, grads, corrs, radii, etas, hetas, stats, b, n, maxinner,
    # mininner, theta, kappa, device, stream
    "sphere_tcg_launch": [_P] * 9 + [_I] * 4 + [_F] * 2 + [_I, _P],
    # the same 9 pointers, u_g, delta_g, alive_g scratch, b, n, maxinner,
    # mininner, theta, kappa, grid, groups, rows, owned, lmax, chunk, device,
    # stream
    "sphere_tcg_resident_launch": [_P] * 12 + [_I] * 4 + [_F] * 2 + [_I] * 7 + [_P],
    # zs, d, xs, ws, ss, grads, radii, etas, hetas, stats, b, n, p, maxinner,
    # mininner, theta, kappa, slices, rows, splits, zs_shared, device, stream
    "stiefel_tcg_launch": [_P] * 10 + [_I] * 5 + [_F] * 2 + [_I] * 5 + [_P],
    # slices, device
    "stiefel_max_clusters": [_I] * 2,
    # z, v0, out, wbuf scratch, r, n, n_iters, prec, col_groups, row_groups,
    # cols, rows_per_group, chunk, device, stream
    "matvec_chain_left_launch": [_P] * 4 + [_I] * 10 + [_P],
    # z, v0, out, n, c, n_iters, prec, cols, slices, rows, zs_shared,
    # device, stream
    "matvec_chain_right_launch": [_P] * 3 + [_I] * 9 + [_P],
    # zs, x, w, v0, corr, u scratch, bar and claims scratch, out, n,
    # n_iters, grid, pieces, piece, stages, xw_shared, device, stream
    "chain_hbm_launch": [_P] * 9 + [_I] * 8 + [_P],
    # a, b, x, batch, n, rows, grid, transposed, device, stream
    "dense_solve_launch": [_P] * 3 + [_I] * 6 + [_P],
    # x, g, y, c, dx, gram, idx, lin, two, p1, out, scale, batch, d, m, grid,
    # device, stream
    "stableid_hvp_launch": [_P] * 11 + [_F] + [_I] * 5 + [_P],
    # l, u, out, outer, inner, l's outer and inner strides, row, column, u's
    # the same, d, grid, device, stream
    "spd_solve_launch": [_P] * 3 + [_L] * 4 + [_I] * 2 + [_L] * 2 + [_I] * 5 + [_P],
}


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")


def build():
    """Compile the kernels unless a library for these sources exists.

    Returns (path, compiler output); the output is empty when the library
    was already built."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in cu]
        procs = []
        try:
            for src, obj in zip(cu, objs):
                procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                              stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
            log = [proc.communicate(timeout=600)[0] for proc in procs]
        finally:  # a timeout or a failed start leaves no compiler running
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [f"{os.path.basename(src)} ({proc.returncode})"
                  for src, proc in zip(cu, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n" + "".join(log))
        lib = os.path.join(tmp, "kernels.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(lib, path)  # atomic: a concurrent loader sees all or nothing
    return path, "".join(log) + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load():
    """The built library with its argtypes declared (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sphere_tcg_error_string.argtypes = [ctypes.c_int]
    lib.sphere_tcg_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err: int, what: str):
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.sphere_tcg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

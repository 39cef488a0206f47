"""The two chains of the PyTorch port (``ops/kernels.py``): K5
``bare_matvec_chain`` and K6 ``chained_barrier_matvec_hbm``.

On the CPU each wrapper runs its plain PyTorch version; those are held to
the JAX Pallas kernels themselves in interpret mode, as
``tests/test_pallas.py`` runs them.  Tolerances (absolute, on unit-norm
rows or columns), each tighter than that file's:

* K5 'highest' 1e-6 and 'high' 1e-5 (``test_pallas.py``: 1e-4, 1e-2): both
  packages compute the same float32 products (the port emulates the bf16x3
  split exactly as the JAX kernel forms it), so only summation order
  differs, ~1e-7 after six passes.
* K5 'default' 2e-2 (``test_pallas.py``: 1e-1): JAX on the CPU computes a
  DEFAULT dot in full float32, while the port rounds both operands to bf16,
  as the TPU's one pass does (~4e-3 after six passes).  A second test holds
  the rounding itself to a reference from bf16-rounded operands, 1e-5.
* K6 1e-6 (``test_pallas.py``: 2e-4): the same float32 chain in both.

The CUDA kernels themselves are compared with the plain versions on the
card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from riptrm_torch.ops import kernels as tk
from riptrm_tpu.ops import pallas_kernels as pk
from riptrm_tpu.problems import nonneg_pca as jn
from riptrm_tpu.solvers.riptrm import RIPTRM, _barrier_ops, init_state

torch.set_num_threads(1)

K5_ATOL = {"highest": 1e-6, "high": 1e-5, "default": 2e-2}


def _z(n=32, seed=0):
    z = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return z + z.T


@pytest.mark.parametrize("precision,left,shape", [
    ("high", True, (4, 32)),
    ("highest", False, (32, 8)),
    ("default", True, (4, 32)),
    ("highest", True, (4, 32)),
    ("high", False, (32, 8)),
    ("highest", False, (32, 12)),  # two groups of 8 columns, the last one ragged
])
def test_bare_chain_matches_pallas(precision, left, shape):
    z = _z()
    v0 = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pk.bare_matvec_chain(jnp.asarray(z), jnp.asarray(v0), 6, precision, left)
    got = tk.bare_matvec_chain(torch.tensor(z), torch.tensor(v0), 6, precision, left)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K5_ATOL[precision], rtol=0)


def test_bare_chain_left_above_the_resident_limit():
    """n = 3000, above K5 left's resident limit on the card (2112): the
    wrapper's plain path takes it on the CPU, as JAX computes any n in
    interpret mode."""
    z = _z(3000, seed=5)
    v0 = np.random.default_rng(6).standard_normal((16, 3000)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = pk.bare_matvec_chain(jnp.asarray(z), jnp.asarray(v0), 3, "highest", True)
    got = tk.bare_matvec_chain(torch.tensor(z), torch.tensor(v0), 3, "highest", True)
    assert got.shape == (16, 3000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K5_ATOL["highest"], rtol=0)


def test_bare_chain_nonsymmetric_z_orientations():
    """v @ Z and Z @ v are different products when Z is not symmetric."""
    z = np.random.default_rng(2).standard_normal((32, 32)).astype(np.float32)
    for left, shape in ((True, (4, 32)), (False, (32, 8))):
        v0 = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = pk.bare_matvec_chain(jnp.asarray(z), jnp.asarray(v0), 6, "highest", left)
        got = tk.bare_matvec_chain(torch.tensor(z), torch.tensor(v0), 6, "highest", left)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("left", [True, False])
def test_bare_chain_default_rounds_operands_to_bf16(left):
    """'default' is one product of bf16-rounded operands per pass: the
    reference rounds with JAX's bfloat16 and multiplies in float64."""
    z = _z()
    v = np.random.default_rng(4).standard_normal((4, 32) if left else (32, 8))
    got = tk.bare_matvec_chain(torch.tensor(z), torch.tensor(v, dtype=torch.float32), 6,
                               "default", left)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16), np.float64)
    v = v.astype(np.float32).astype(np.float64)
    for _ in range(6):
        w = bf(v) @ bf(z) if left else bf(z) @ bf(v)
        v = w / np.sqrt(np.sum(w * w, axis=1 if left else 0, keepdims=True) + 1e-30)
    np.testing.assert_allclose(got.numpy(), v, atol=1e-5, rtol=0)


@pytest.mark.parametrize("left", [True, False])
def test_bare_chain_rounding_rules_are_distinct(left):
    """One pass at n = 256: each precision's rounding rule moves the result
    by more than 1e-6 (relative 2-norm) from the others', the limit that
    ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernel to
    against its own rule ('high' is ~4e-6 from 'highest', 'default'
    ~2e-3 from both)."""
    z = torch.tensor(_z(256, seed=5))
    v0 = torch.tensor(np.random.default_rng(6).standard_normal((8, 256) if left else (256, 8)),
                      dtype=torch.float32)
    out = {p: tk.bare_matvec_chain(z, v0, 1, p, left) for p in ("highest", "high", "default")}
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double()))
    assert 2e-6 < rel(out["high"], out["highest"]) < 1e-5
    assert rel(out["default"], out["highest"]) > 1e-3
    assert rel(out["default"], out["high"]) > 1e-3


def test_bare_chain_refuses_bad_arguments():
    z = torch.tensor(_z())
    with pytest.raises(ValueError, match="precision"):
        tk.bare_matvec_chain(z, torch.ones(2, 32), 1, "fast")
    with pytest.raises(ValueError, match="shape mismatch"):
        tk.bare_matvec_chain(z, torch.ones(2, 31), 1, "high", True)


@pytest.fixture(scope="module", params=[64, 200], ids=["n64", "n200"])
def chain_case(request):
    """``tests/test_pallas.py``'s chain fixture at n = 64 and at n = 200,
    which the JAX kernel pads to 256."""
    n = request.param
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    data = jn.generate_instance(k1, n)
    x0 = np.abs(np.asarray(jax.random.normal(k2, (n,))))
    x0 /= np.linalg.norm(x0)
    problem = jn.make_problem(data["Z"], x0, dtype=jnp.float32)
    opt = RIPTRM({"TRS_solver": "tCG", "second_order_stationarity": False}).option
    st = init_state(problem, opt)
    c, _, _ = _barrier_ops(problem, st.x, st.y, st.mu)
    v0 = problem.manifold.random_tangent(jax.random.PRNGKey(1), st.x)
    return tuple(np.asarray(a, np.float32)
                 for a in (problem.structure["Zs"], st.x, st.y / c, v0))


def test_hbm_chain_matches_pallas(chain_case):
    zs, x, w, v0 = chain_case
    n = zs.shape[0]
    with pltpu.force_tpu_interpret_mode():
        want = pk.chained_barrier_matvec_hbm(*map(jnp.asarray, chain_case), 3,
                                             block=pk.pick_hbm_block(n))
    got = tk.chained_barrier_matvec_hbm(*map(torch.tensor, chain_case), 3)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_hbm_chain_is_k1s_function(chain_case):
    """K6 and K1 compute one function: on the CPU both take K1's plain version."""
    args = tuple(map(torch.tensor, chain_case))
    torch.testing.assert_close(tk.chained_barrier_matvec_hbm(*args, 5),
                               tk.chained_barrier_matvec(*args, 5), atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_chains():
    tk.reset_launch_counts()
    z = torch.tensor(_z())
    tk.bare_matvec_chain(z, torch.ones(2, 32), 2, "highest")
    tk.bare_matvec_chain(z, torch.ones(32, 3), 2, "high", False)
    v = torch.ones(32) / 32 ** 0.5
    tk.chained_barrier_matvec_hbm(z, v, torch.ones(32), v, 2)
    counts = tk.launch_counts()
    assert counts["bare_matvec_chain"] == counts["chained_barrier_matvec_hbm"] == 0
    assert set(counts) == {fn.__name__ for fn in tk.KERNEL_WRAPPERS}

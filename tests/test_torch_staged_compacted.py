"""The compacted staged-precision solve
(``riptrm_torch/parallel/sweep.py::staged_precision_riptrm_compacted``)
against the JAX function on the same inputs: the case of
``tests/test_parallel.py::test_staged_precision_compacted_matches_floor``
(NonnegPCA n = 32, B = 4 from the committed payload, float32, phase 2 with
10x tighter floors and tolresid 1e-5, segments of 60 steps)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import torch

from riptrm_torch.experiment import chip_sweep as tcs
from riptrm_torch.parallel import sweep as tsw
from riptrm_tpu.experiment import chip_sweep as jcs
from riptrm_tpu.parallel.sweep import staged_precision_riptrm_compacted as jax_compacted
from riptrm_tpu.problems import nonneg_pca as jnp_pca

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(floor, clamp):
    option = {
        "maxiter": 60, "tolresid": 1e-3, "TRS_solver": "tCG",
        "second_order_stationarity": False,
        "forcing_function_Lagrangian": lambda mu: clamp(mu, 1e-4),
        "forcing_function_complementarity": lambda mu: clamp(1e-3 * mu, 2e-4),
    }
    option_hi = option | {
        "tolresid": floor,
        "forcing_function_Lagrangian": lambda mu: clamp(mu, 1e-5),
        "forcing_function_complementarity": lambda mu: clamp(1e-3 * mu, 2e-5),
    }
    return option, option_hi


def test_staged_precision_compacted_matches_jax(monkeypatch):
    # both packages read the committed payload
    monkeypatch.setenv("RIPTRM_CACHE_DIR", os.path.join(REPO, "dataset", "_cache"))
    jp, jxs, jys = jcs.build_sweep("NonnegPCA", 32, 4, seed=0)
    jp_hi = jnp_pca.make_problem(jp.structure["Zs"], np.asarray(jxs[0]), dtype=jnp.float32,
                                 matmul_precision="highest")
    jbest, jres1, jsegs = jax_compacted(jp, jp_hi, *_options(1e-5, jnp.maximum),
                                        max_steps=300, segment_steps=60)(jxs, jys)

    tp, txs, tys = tcs.build_sweep("NonnegPCA", 32, 4, device="cpu")
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    tp_hi = dataclasses.replace(tp, matmul_precision="highest")
    clamp = lambda a, lo: torch.clamp(a, min=lo)  # noqa: E731
    best, res1, segs = tsw.staged_precision_riptrm_compacted(
        tp, tp_hi, *_options(1e-5, clamp), max_steps=300, segment_steps=60)(txs, tys)

    assert best.shape == (4,) and segs.shape == (4,) and segs.dtype == np.int64
    # the JAX test's contract: phase 2 does not regress phase 1, reaches the
    # tighter class, and every lane left the active set within the budget
    assert np.all(best <= res1 * (1 + 1e-5))
    assert np.median(best) < 1e-4
    assert np.all(segs >= 1)
    # against the JAX function: the float32 phase-1 floors agree, both
    # phase 2s reach the tolerance, in the same segments
    np.testing.assert_allclose(res1, np.asarray(jres1), rtol=1e-3)
    assert np.all(best <= 1e-5) and np.all(np.asarray(jbest) <= 1e-5)
    np.testing.assert_array_equal(segs, np.asarray(jsegs))


def test_compaction_buckets_and_merge():
    """Lanes leave on the tolerance or on a floored segment; the active
    lanes run in a power-of-two bucket padded by the first active lane, and
    only their own rows are merged back (the others are not touched)."""
    tp, txs, tys = tcs.build_sweep("NonnegPCA", 32, 4, device="cpu")
    tp_hi = dataclasses.replace(tp, matmul_precision="highest")
    clamp = lambda a, lo: torch.clamp(a, min=lo)  # noqa: E731
    option, option_hi = _options(1e-9, clamp)  # unreachable: lanes leave on the floor
    widths = []
    cont = tsw.batched_riptrm_continue

    def spy(problem, opt, steps):
        run = cont(problem, opt, steps)

        def counted(st):
            widths.append(st.x.shape[0])
            return run(st)

        return counted

    tsw.batched_riptrm_continue = spy
    try:
        best, res1, segs = tsw.staged_precision_riptrm_compacted(
            tp, tp_hi, option, option_hi, max_steps=120, segment_steps=20)(txs[:3], tys[:3])
    finally:
        tsw.batched_riptrm_continue = cont
    # a lane leaves for good: the batches shrink, each the bucket of its
    # active lanes (B = 3: 3, 2 or 1), the first with every lane
    assert widths[0] == 3 and widths == sorted(widths, reverse=True)
    assert set(widths) <= {1, 2, 3}
    assert segs.max() == len(widths) <= 120 // 20 and np.all(segs >= 1)
    assert np.all(best <= res1)
    assert [tsw._bucket(a, 128) for a in (1, 2, 3, 5, 64, 65, 128)] == [1, 2, 4, 8, 64, 128, 128]
    assert tsw._bucket(3, 3) == 3

"""The port's roofline entry point (``riptrm_torch/experiment/roofline.py``)
on the CPU: its accounting against hand-counted numbers, its steady-state
cases through the kernels' plain versions, its row arithmetic, and its
refusal to run without CUDA.  The timings themselves exist only on the
card (``chip_smoke.py`` phase 9).
"""

import pytest
import torch

from riptrm_torch.experiment import roofline as rl
from riptrm_torch.manifolds import Sphere, Stiefel
from riptrm_torch.ops import kernels as tk

torch.set_num_threads(1)


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / 67e12, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e6, "operations" if t_ops >= t_bytes else "bytes"


@pytest.mark.parametrize("work,ops,nbytes,bound_by", [
    # K1 / K6, n = 1000, K = 64: K (2 n^2 + 17 n); Zs, x, y/c, v0 in, v out
    (lambda: rl.chain_work(1000, 64), 64 * (2e6 + 17e3), 4 * (1e6 + 4e3), "operations"),
    # K6, n = 4000, K = 1: one pass over 64 MB of Zs sets the bound
    (lambda: rl.chain_work(4000, 1), 32e6 + 68e3, 4 * (16e6 + 16e3), "bytes"),
    # K6, n = 4000, K = 64: Zs (64 MB) is above the 50 MB L2, so each
    # iteration reads it again
    (lambda: rl.chain_work(4000, 64), 64 * (32e6 + 68e3), 64 * 64e6 + 4 * 16e3, "bytes"),
    # K5 left beyond the L2: Z read on each of 3 passes, 2 rows in and out
    (lambda: rl.bare_chain_work(4000, 2, 3), 3 * 2 * (32e6 + 12e3),
     3 * 64e6 + 4 * 2 * 2 * 4000, "bytes"),
    # K3 beyond the L2: Zs read on each iteration of the longest lane (7)
    (lambda: rl.sphere_tcg_work(4000, [5, 7]), 12 * (32e6 + 160e3),
     7 * 64e6 + 4 * (5 * 2 * 4000 + 6), "bytes"),
    # K5 right, St(128, 8) frames of 128 lanes (c = 1024), K = 10
    (lambda: rl.bare_chain_work(128, 1024, 10), 10 * 1024 * (2 * 128**2 + 3 * 128),
     4 * (128**2 + 2 * 1024 * 128), "operations"),
    # K3, n = 1000, 16 lanes of 64 iterations: 2 n^2 + 40 n per lane-iteration;
    # Zs, xs, ws, grads, radii in; etas, Hetas, stats out
    (lambda: rl.sphere_tcg_work(1000, [64] * 16), 1024 * (2e6 + 40e3),
     4 * (1e6 + 5 * 16 * 1000 + 3 * 16), "operations"),
    # K4, St(128, 8), 128 lanes of 64 iterations: 2 n^2 p + 10 n p^2 + 30 n p
    (lambda: rl.stiefel_tcg_work(128, 8, [64] * 128),
     8192 * (2 * 128**2 * 8 + 10 * 128 * 64 + 30 * 1024),
     4 * (128**2 + 8 + 5 * 128 * 1024 + 128 * 64 + 3 * 128), "operations"),
    # K4 with lanes stopping early: only each lane's own iterations count
    (lambda: rl.stiefel_tcg_work(16, 2, [3, 0, 5]), 8 * (2 * 256 * 2 + 10 * 16 * 4 + 30 * 32),
     4 * (256 + 2 + 5 * 3 * 32 + 3 * 4 + 9), "bytes"),
])
def test_accounting_by_hand(work, ops, nbytes, bound_by):
    got_ops, got_bytes = work()
    assert got_ops == pytest.approx(ops, rel=1e-12)
    assert got_bytes == pytest.approx(nbytes, rel=1e-12)
    bound_us, by = rl.roofline_bound(got_ops, got_bytes)
    assert by == bound_by
    assert bound_us == pytest.approx(_bound(ops, nbytes)[0], rel=1e-12)


@pytest.mark.parametrize("n,passes,reads", [
    (1000, 64, 1),  # 4 MB stays in the L2
    (3620, 64, 1),  # 52.4 MB, just under the 50 MiB L2
    (3630, 64, 64),  # 52.7 MB, just over
    (4000, 0, 1),  # a call that runs no pass still reads its input once
])
def test_zs_bytes_follow_the_l2(n, passes, reads):
    assert rl.zs_bytes(n, passes) == reads * 4 * n * n


def test_bound_of_a_k1_call_in_microseconds():
    """K = 64 at n = 1000: 129.088 MFLOP over 67 TFLOP/s = 1.92669 us, above
    the 4.016 MB over 3.35 TB/s = 1.19881 us."""
    bound_us, by = rl.roofline_bound(*rl.chain_work(1000, 64))
    assert bound_us == pytest.approx(1.926686567, rel=1e-9) and by == "operations"


@pytest.mark.parametrize("family", ["sphere", "stiefel"])
def test_steady_state_cases_run_maxinner(family):
    """At n = 32, B = 4 (p = 2), maxinner = 6 every lane of every coupled
    call runs exactly maxinner iterations (stop code 0)."""
    n, b, p, maxinner = 32, 4, 2, 6
    if family == "sphere":
        case = rl.sphere_case(n, b, "cpu")
        xs, grads, man = case[1], case[3], Sphere(n)
        kernel = tk.fused_tcg_sphere_quadratic_batched
    else:
        case = rl.stiefel_case(n, b, p, "cpu")
        xs, grads, man = case[2], case[5], Stiefel(n, p)
        kernel = tk.fused_tcg_stiefel_bound_batched
        assert float(xs.abs().max()) < 0.8
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in case)
    call, couple = rl.steady_calls(kernel, case, man, xs, maxinner)
    g = grads
    for _ in range(3):
        if family == "sphere":  # (0.7 Q is off St(n, p), where P is no projector)
            torch.testing.assert_close(man.proj(xs, g), g)  # a tangent gradient
        eta, _, iters, codes = call(g)
        assert iters.tolist() == [maxinner] * b and codes.tolist() == [0] * b
        g = couple(eta)


def test_tcg_row_arithmetic():
    """10 calls of 4 lanes in 100 ms, lanes of 64 and 32 iterations."""
    its = torch.tensor([[64, 64, 32, 32]] * 10, dtype=torch.int32)
    work = lambda it: rl.sphere_tcg_work(100, it)
    row = rl.tcg_row("K3", 100, 4, 100.0, 10, its, work, 12800.0)
    ops = 10 * 192 * (2 * 100**2 + 40 * 100)
    assert row["mean_tcg_iters_per_call"] == 64
    assert row["kernel_calls_per_s"] == pytest.approx(100.0)
    assert row["tcg_iters_per_s"] == pytest.approx(6400.0)
    assert row["achieved_tflops"] == pytest.approx(ops / 0.1 / 1e12)
    assert row["pct_fp32_peak"] == pytest.approx(100 * ops / 0.1 / 67e12)
    bound_us, by = _bound(ops / 10, 4 * (100**2 + 5 * 4 * 100 + 12))
    assert (row["bound_us_per_call"], row["bound_by"]) == (pytest.approx(bound_us), by)
    assert row["pct_of_bound"] == pytest.approx(100 * bound_us / 10e3)
    assert row["pct_of_bare_matvec_chain"] == pytest.approx(50.0)


def test_stiefel_row_times_the_chains_own_plan(monkeypatch):
    """The Stiefel rows' denominator is K5 right on the B lanes' frames side
    by side, [n, B p], cut by the chain's own plan (``matvec_right_plan``),
    not one group per lane: the card's best scheme for the product."""
    calls = []
    real = tk.bare_matvec_chain

    def spy(zs, v0, n_iters, precision="high", left=True, **kw):
        calls.append((tuple(v0.shape), precision, left, kw))
        return real(zs, v0, n_iters, precision, left, **kw)

    monkeypatch.setattr(rl.k, "bare_matvec_chain", spy)
    monkeypatch.setattr(rl, "time_tcg_chain",
                        lambda call, couple, g0: (1.0, 1, torch.full((1, 4), 6)))
    monkeypatch.setattr(rl, "time_chain", lambda fn: (fn(2), (1.0, 2))[1])
    row = rl.stiefel_row(32, 2, 4, 6, "cpu")
    assert calls == [((32, 8), "highest", False, {})]
    assert row["bare_chain_iters_per_s"] == pytest.approx(2000.0)


def test_main_refuses_sizes_above_the_left_chain_limit(monkeypatch, tmp_path, capsys):
    """An n beyond K5 left's limit (resident to 2112 on 132 SMs, then the
    right chain on the transposes to 7200) is refused up front, before any
    row runs or the output is written."""
    monkeypatch.setattr(rl, "cuda_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(rl, "sphere_row", lambda *a: pytest.fail("a row ran"))
    out = tmp_path / "roofline.json"
    with pytest.raises(SystemExit):
        rl.main(["--sizes", "1000", "2113", "7201", "--out", str(out)])
    err = capsys.readouterr().err
    assert "--sizes 7201" in err and "--sizes 2113" not in err
    assert not out.exists()


def test_main_refuses_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "roofline.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rl.main(["--out", str(out)])
    assert not out.exists()

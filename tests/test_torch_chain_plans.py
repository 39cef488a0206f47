"""The cooperative-grid plans of the PyTorch port's chain kernels
(``ops/kernels.py``): K1 ``chained_barrier_matvec`` and K5
``bare_matvec_chain`` in the left orientation.

Both kernels hold their matrix in the shared memory of a cooperative grid,
one CTA per SM, for the whole call (``csrc/matvec_chain.cu``).  The plans
are pure Python, so their cuts, their shared-memory sizes and their
refusals are tested here; the kernels themselves on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest
import torch

from riptrm_torch.ops import kernels as tk

torch.set_num_threads(1)


@pytest.mark.parametrize("n,grid,rows", [
    (64, 64, 1),  # one row per CTA, fewer CTAs than SMs
    (250, 125, 2),
    (1000, 125, 8),  # the NonnegPCA benchmark's n: 8 rows, 32 KB of Zs per CTA
    (1001, 126, 8),
    (2508, 132, 19),  # the largest resident n on 132 SMs
])
def test_chain_resident_plan(n, grid, rows):
    g, r, nbytes = tk.chain_resident_plan(n)
    ldk = -(-n // 4) * 4
    assert (g, r) == (grid, rows)
    assert (g - 1) * r < n <= g * r <= tk.H100_SMS * r
    assert nbytes == 4 * ((r + 2) * ldk + 2 * n + r) <= tk.MAX_SMEM_BYTES


@pytest.mark.parametrize("sms,largest", [(132, 2508), (114, 2312)])
def test_chain_resident_limit(sms, largest):
    """The largest resident n follows the SM count (an H100 SXM has 132, a
    PCIe card 114); one more is refused with a message that names K6."""
    assert tk.chain_resident_max_n(sms) == largest
    tk.chain_resident_plan(largest, sms)
    with pytest.raises(ValueError, match="chained_barrier_matvec_hbm"):
        tk.chain_resident_plan(largest + 1, sms)


def test_chain_kernel_refuses_above_resident_limit():
    """The wrapper refuses an n above the H100's resident limit on either
    device (a CPU tensor is planned for 132 SMs), before its plain version
    runs."""
    n = tk.chain_resident_max_n() + 1
    zs = torch.zeros((n, n))
    v = torch.ones(n) / n ** 0.5
    with pytest.raises(ValueError, match="chained_barrier_matvec_hbm"):
        tk.chained_barrier_matvec(zs, v, v, v, 2)
    m = n - 1  # the largest resident n still runs
    out = tk.chained_barrier_matvec(torch.eye(m), v[:m], v[:m], v[:m], 1)
    assert out.shape == (m,)


@pytest.mark.parametrize("r,n,plan", [
    (1, 1000, (125, 1, 8, 1, 8)),
    (16, 250, (63, 2, 4, 8, 8)),
    (16, 1000, (63, 2, 16, 8, 8)),  # 16 columns, 64 KB of Z per CTA
    (16, 1001, (63, 2, 16, 8, 8)),
    (64, 1000, (33, 4, 31, 16, 16)),
    (128, 1000, (33, 4, 31, 32, 16)),  # two equal chunks of staged rows
    (128, 1500, (66, 2, 23, 64, 8)),  # 4 row groups do not fit: 2
    (128, 2112, (132, 1, 16, 128, 8)),  # the largest n at one row group
])
def test_left_plan(r, n, plan):
    p = tk.matvec_left_plan(r, n)
    assert tuple(p)[:5] == plan
    assert (p.col_groups - 1) * p.cols < n <= p.col_groups * p.cols
    assert (p.row_groups - 1) * p.rows < r <= p.row_groups * p.rows
    assert p.col_groups * p.row_groups <= tk.H100_SMS
    assert p.chunk % tk.LEFT_TILE == 0 and p.chunk <= -(-p.rows // 8) * 8
    chunks = -(-p.rows // p.chunk)  # as few as fit, of equal size
    assert chunks * p.chunk - p.rows < tk.LEFT_TILE * chunks
    cp, ldk = -(-p.cols // 8) * 8, -(-n // 4) * 4
    warps = tk.MATVEC_LEFT_THREADS // 32
    assert p.smem == 4 * ((cp + p.chunk) * ldk + p.rows * (cp + 1) + warps * 64)
    assert p.smem <= tk.MAX_SMEM_BYTES


@pytest.mark.parametrize("r,n,groups", [
    (8, 1000, 1),  # fewer than 16 rows: one group
    (16, 1000, 2),
    (128, 1000, 4),
    (128, 1500, 2),  # 4 groups do not fit: halved
])
def test_left_plan_row_groups(r, n, groups):
    """The default plan cuts the rows into min(4, r // 8) groups, halved
    until the plan fits; each group takes ceil(r / g) rows and the SMs left
    to it take the columns."""
    p = tk.matvec_left_plan(r, n)
    assert (p.row_groups, p.rows) == (groups, -(-r // groups))
    assert p.cols == -(-n // (tk.H100_SMS // groups))


def test_left_plan_refuses_above_its_limit():
    tk.matvec_left_plan(16, 2112)
    with pytest.raises(ValueError, match="shared memory"):
        tk.matvec_left_plan(16, 2113)
    with pytest.raises(ValueError, match="shared memory"):
        tk.matvec_left_plan(128, 2113)  # no row-group count fits
    with pytest.raises(ValueError, match="shared memory"):
        tk.bare_matvec_chain(torch.zeros(2113, 2113), torch.ones(4, 2113), 1, "highest")


def test_right_orientation_has_no_left_plan():
    """The right orientation keeps its one CTA per group of columns: an n
    beyond the left plan's limit still runs there."""
    out = tk.bare_matvec_chain(torch.eye(2113), torch.ones(2113, 2), 1, "highest", False)
    assert out.shape == (2113, 2)

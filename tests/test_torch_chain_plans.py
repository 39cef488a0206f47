"""The plans of the PyTorch port's chain kernels (``ops/kernels.py``): K1
``chained_barrier_matvec``, K5 ``bare_matvec_chain`` in both orientations
and K6 ``chained_barrier_matvec_hbm``.

K1 and K5 left hold their matrix in the shared memory of a cooperative
grid, one CTA per SM, for the whole call; K5 right cuts Z into row slices
across a thread-block cluster per group of columns; K6 streams Zs through a
ring of shared-memory stages on a cooperative grid (``csrc/matvec_chain.cu``).
The plans are pure Python, so their cuts, their shared-memory sizes and
their refusals are tested here; the kernels themselves on the card in
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
    # the plan binds the card only: on the CPU the plain version takes any n
    z = torch.eye(2113)
    out = tk.bare_matvec_chain(z, torch.ones(4, 2113), 1, "highest")
    torch.testing.assert_close(out, tk.bare_matvec_chain_plain(z, torch.ones(4, 2113), 1,
                                                               "highest"))


@pytest.mark.parametrize("r,n,resident", [
    (16, 1000, True), (128, 1000, True), (16, 2112, True),
    (16, 2113, False), (128, 2113, False), (16, 3000, False), (4, 7200, False),
])
def test_left_chain_route(r, n, resident):
    """Above the left chain's resident limit the card runs the right chain
    on the transposes: its plan for Z^T [n, n] and v^T [n, r]."""
    is_resident, plan = tk.left_chain_plan(r, n)
    assert is_resident == resident
    if resident:
        assert plan == tk.matvec_left_plan(r, n)
    else:
        assert plan == tk.matvec_right_plan(n, r)


def test_left_chain_route_refuses_above_the_right_plans_limit():
    tk.left_chain_plan(16, 7200)
    with pytest.raises(ValueError, match="shared memory"):
        tk.left_chain_plan(16, 7201)


def test_right_orientation_has_no_left_plan():
    """The right orientation keeps its one CTA per group of columns: an n
    beyond the left plan's limit still runs there."""
    out = tk.bare_matvec_chain(torch.eye(2113), torch.ones(2113, 2), 1, "highest", False)
    assert out.shape == (2113, 2)


# The right chain's former design, one CTA per group of 8 columns holding
# the group's V and W (2 n 8 floats) and 8 norms in one block's shared
# memory, took n up to 3615; the cluster design keeps that range.
GROUP8_MAX_N = 3615


@pytest.mark.parametrize("n,c,precision,plan", [
    (128, 128, "highest", (8, 16, 8, 16, True)),  # St(128, 8) x 16 lanes: clusters of 8
    (128, 512, "highest", (8, 64, 2, 64, True)),  # x 64 lanes: clusters of 2
    (128, 1024, "highest", (8, 128, 1, 128, True)),  # x 128 lanes: one CTA a group
    (128, 3, "high", (4, 1, 8, 16, True)),  # c <= 4: one group of 4 columns
    (32, 12, "highest", (8, 2, 8, 4, True)),  # a ragged last group
    (512, 16, "highest", (8, 2, 8, 64, True)),
    (512, 16, "high", (8, 2, 8, 64, False)),  # hi and lo do not fit: Z through L2
    (1000, 16, "highest", (8, 2, 8, 128, False)),
    (GROUP8_MAX_N, 8, "highest", (4, 2, 8, 452, False)),  # 8 columns of v do not fit
])
def test_right_plan(n, c, precision, plan):
    p = tk.matvec_right_plan(n, c, precision=precision)
    assert (p.cols, p.groups, p.slices, p.rows, p.zs_shared) == plan
    assert (p.groups - 1) * p.cols < c <= p.groups * p.cols
    assert p.rows % tk.RIGHT_TILE == 0 and p.rows * p.slices >= n
    assert p.rows * (p.slices - 1) < n  # no slice is all padding
    assert p.slices <= 8  # the portable cluster size
    assert p.slices == 1 or p.groups * p.slices <= tk.H100_SMS
    tiles = p.rows // tk.RIGHT_TILE * (p.cols // tk.RIGHT_TILE)
    assert p.split == max(1, tk.MATVEC_RIGHT_THREADS // tiles)
    red = tk.MATVEC_RIGHT_THREADS * 16 if p.split > 1 else 0
    zs = (2 if precision == "high" else 1) * n * p.rows
    base = 2 * p.rows * p.slices * p.cols + 2 * p.slices * p.cols + red
    assert p.smem == 4 * (base + (zs if p.zs_shared else 0)) <= tk.MAX_SMEM_BYTES
    assert p.zs_shared or 4 * (base + zs) > tk.MAX_SMEM_BYTES  # L2 only where Z does not fit


@pytest.mark.parametrize("c", [1, 5, 8, 1024])
def test_right_plan_takes_every_n_up_to_3615(c):
    """Every n that the former right chain took with a group of 8 columns
    has a plan, at any c and in every precision."""
    for precision in tk.PRECISIONS:
        for n in range(1, GROUP8_MAX_N + 1):
            p = tk.matvec_right_plan(n, c, precision=precision)
            assert p.smem <= tk.MAX_SMEM_BYTES and p.rows * p.slices >= n


def test_right_plan_refuses_above_its_limit():
    """v at 4 columns, double-buffered, fills a block's shared memory above
    n = 7200; the plan binds the card only, and on the CPU the wrapper's
    plain version takes such an n."""
    tk.matvec_right_plan(7200, 8)
    with pytest.raises(ValueError, match="shared memory"):
        tk.matvec_right_plan(7201, 8)
    out = tk.bare_matvec_chain(torch.eye(7201), torch.ones(7201, 2), 1, "highest", False)
    assert out.shape == (7201, 2) and bool(torch.all(torch.isfinite(out)))


@pytest.mark.parametrize("n,grid,cap,pieces,piece,stages,xw_shared", [
    (1, 1, 1, 1, 4, 32, True),
    (200, 132, 4, 1, 200, 32, True),
    (1000, 132, 16, 1, 1000, 32, True),
    (1001, 132, 16, 1, 1004, 32, True),  # n % 4 != 0: the chunk padded to 16 bytes
    (4000, 132, 62, 2, 2000, 16, True),  # the roofline's n: 16 stages of 8000 bytes
    (8200, 132, 126, 5, 1640, 16, True),
    (10000, 132, 152, 5, 2000, 16, False),  # x and w would leave one stage per warp
    (28928, 132, 440, 15, 1932, 8, False),  # the largest n
])
def test_hbm_plan(n, grid, cap, pieces, piece, stages, xw_shared):
    p = tk.chain_hbm_plan(n)
    assert tuple(p)[:6] == (grid, cap, pieces, piece, stages, xw_shared)
    assert p.grid <= min(n, tk.H100_SMS)  # one CTA per SM: co-resident
    assert p.cap == min(n, 2 * -(-n // p.grid))  # the CTAs' caps cover the rows twice
    assert p.piece % 4 == 0 and p.piece <= tk.HBM_PIECE
    assert (p.pieces - 1) * p.piece < n <= p.pieces * p.piece
    assert p.stages % tk.HBM_WARPS == 0 and tk.HBM_WARPS <= p.stages <= tk.HBM_MAX_STAGES
    fixed = -(-n // 4) * 4 * (3 if p.xw_shared else 1) + p.cap * (p.pieces + 2)
    assert p.smem == 4 * (p.stages * p.piece + fixed) <= tk.MAX_SMEM_BYTES
    # another stage per warp would not fit, unless the most are taken
    more = 4 * ((p.stages + tk.HBM_WARPS) * p.piece + fixed)
    assert p.stages == tk.HBM_MAX_STAGES or more > tk.MAX_SMEM_BYTES


def test_hbm_plan_takes_every_n_up_to_its_limit():
    """Every n that two n-vectors leave in one block's shared memory (the
    range of K6's former design) has a plan; one more is refused, by the wrapper
    too on the CPU."""
    largest = tk.MAX_SMEM_BYTES // 8
    for n in range(1, largest + 1):
        p = tk.chain_hbm_plan(n)
        assert p.smem <= tk.MAX_SMEM_BYTES and p.pieces * p.piece >= n
    with pytest.raises(ValueError, match="shared memory"):
        tk.chain_hbm_plan(largest + 1)
    n = largest + 1
    v = torch.ones(n) / n ** 0.5
    with pytest.raises(ValueError, match="shared memory"):
        tk.chained_barrier_matvec_hbm(torch.zeros(1, 1).expand(n, n), v, v, v, 1)

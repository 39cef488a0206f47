"""The StableIdentification family of the benchmark on the CPU: the plain
reference's KKT residual against the port's, its closed-form gradient
against autograd, the fixed pool of starts, and one float32 solve of the
port judged by the reference."""

import functools
import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.gen import stable_identification as gen
from perfbench.program import stable_identification as program
from perfbench.reference import stable_identification as reference
from perfbench.tests.conftest import REPO

CELL = "stableid-d5.riptrm-generic-sweep-b131072"
CFG = json.loads((REPO / "perfbench/configs/stableid-d5.json").read_text())
SEED = 2**31 + 20


def _points(lanes, seed=SEED):
    """Interior points [lanes, 3, 5, 5] (perturbed pool starts) and
    positive multipliers [lanes, 16], float64, from ``seed``."""
    rng = harness.rng_for(seed)
    x = gen.starts(rng, CFG, 20 + lanes)[20:]
    y = rng.uniform(0.1, 3.0, (lanes, 16))
    return torch.tensor(x), torch.tensor(y)


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_residual_matches_the_port(seed):
    """At 16 seeded interior points and positive multipliers, the
    reference's residual is the port's ``compute_residual`` on its
    StableIdentification problem, in float64, to 1e-10 relative."""
    from riptrm_torch.ops.kkt import compute_residual

    arrays = gen.instance(None, CFG)
    x, y = _points(16, seed)
    cfg = CFG | {"dtype": "float64"}
    problem = program.make_problem(arrays, x[0], cfg, torch.device("cpu"), None)
    port = compute_residual(problem, x, y)[0]
    ref = reference.residual(arrays, CFG, x, y)
    assert torch.all(torch.isfinite(ref)) and torch.all(ref > 0)
    assert torch.max(torch.abs(port - ref) / ref) < 1e-10


def test_closed_form_gradient_is_autograds():
    """The reference's Euclidean gradient of f + y'g in (J, R, Q) is
    autograd's of the published cost plus the multipliers' constraints."""
    arrays = gen.instance(None, CFG)
    x, y = _points(16)
    xg = x.clone().requires_grad_(True)
    g, _ = reference.constraint_values(arrays, xg)
    (reference.cost(arrays, CFG, xg).sum() + (y * g).sum()).backward()
    closed = reference.lagrangian_egrad(arrays, CFG, x, y)
    assert torch.allclose(closed, xg.grad, rtol=1e-12, atol=1e-12)


def test_manifold_violation_and_not_positive_definite():
    """A point off the manifold reads its distance in the residual; a lane
    whose R is not positive definite, or holds a NaN, reads not finite."""
    arrays = gen.instance(None, CFG)
    x, y = _points(3)
    base = reference.residual(arrays, CFG, x, y)
    x = x.clone()
    x[0, 0, 0, 1] += 1e-3  # J no longer skew
    x[1, 1] = -x[1, 1]  # R negative definite
    x[2, 2, 0, 0] = float("nan")
    out = reference.residual(arrays, CFG, x, y)
    assert out[0] > base[0] and not torch.isfinite(out[1:]).any()


@functools.lru_cache(maxsize=None)
def _pool(count):
    stream = np.random.SeedSequence(CFG["instance_seed"], spawn_key=(0,))
    return gen.starts(np.random.default_rng(stream), CFG, count)


@pytest.mark.parametrize("count", [20, 64, 257])
def test_pool_is_interior_and_fixed(count):
    """The pool repeats from its stream; every lane is strictly inside the
    16 constraints with R and Q positive definite and J skew, and lanes
    0-19 are the shipped starts a-t unchanged."""
    pool = _pool(count)
    stream = np.random.SeedSequence(CFG["instance_seed"], spawn_key=(0,))
    assert np.array_equal(pool, gen.starts(np.random.default_rng(stream), CFG, count))
    assert pool.shape == (count, 3, 5, 5)
    constset = gen.instance(None, CFG)["constset"]
    assert np.all(gen.constraint_values(constset, pool) < 0)
    assert np.all(np.linalg.eigvalsh(pool[:, 1:]) > 0)
    assert np.array_equal(pool[:, 0], -pool[:, 0].swapaxes(-1, -2))
    assert np.array_equal(pool[:, 1:], pool[:, 1:].swapaxes(-1, -2))
    assert np.array_equal(pool[:20], gen.shipped_starts(CFG))
    if count > 20:
        moved = pool[20:] - gen.shipped_starts(CFG)[np.arange(20, count) % 20]
        share = np.linalg.norm(moved, axis=(2, 3)) / np.linalg.norm(pool[20:] - moved,
                                                                    axis=(2, 3))
        assert np.allclose(share, CFG["perturbation"])


@functools.lru_cache(maxsize=None)
def _solve():
    """Four pool lanes solved by the port in float32 at the rehearsal's
    tolerance through the cell's own entry: (cell, arrays, the pool, the
    call)."""
    cell = harness.find_cell(CELL)
    cell.config = cell.config | cell.config["rehearsal"]
    cell.traffic = cell.traffic | {"lanes": 4, "pool_sweeps": 1, "max_steps": 200}
    arrays, starts = harness.make_inputs(cell, SEED)
    pool = torch.as_tensor(starts, dtype=torch.float32)
    problem = cell.program.make_problem(arrays, pool[0, 0], cell.config, torch.device("cpu"),
                                        cell.config["matmul_precision"])
    run = cell.entry.build(problem, cell.config, cell.traffic, cell.traffic["max_steps"])
    x, y, steps, res = run(pool[0], torch.ones(4, problem.num_ineq))
    return cell, arrays, pool, harness.Call(0, 0.0, 1.0, x, y, steps.numpy(), res)


@pytest.mark.parametrize("altered", [False, True], ids=["as_solved", "answer_altered"])
def test_port_solve_judged_by_the_reference(altered):
    """A float32 solve of 4 pool lanes is correct by the reference; one
    answer moved by 1e-2 after the solve is not."""
    cell, arrays, pool, call = _solve()
    if altered:
        x = call.x.clone()
        x[0] = x[0] + 1e-2
        call = harness.Call(0, 0.0, 1.0, x, call.y, call.steps, call.residual)
    attempted, failed, checks = harness.judge(cell, arrays, [call], pool, [])
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    assert attempted == 4 and correct is not altered, checks
    assert failed == (1 if altered else 0)

"""Faults planted under the timed path make ``correct`` come out false,
at a tiny size on the CPU (the harness's look for a card skipped): a step
that returns its state unchanged, half of the lanes left out, an answer
altered where it is produced, and a tCG step's Hessian image altered
where the kernel produces it.  (A cell here runs on one card: it has no
exchange between chips to leave out.)"""

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_rehearsal import CELLS, rehearse

TCG_CELLS = [name for name in CELLS if "tcg_heta_gap" in harness.load_json(
    REPO / "perfbench" / "checks" / f"{name}.json")["numbers"]]


def step_unchanged(monkeypatch):
    """Every solver's step factory returns a step that keeps its state."""
    from riptrm_torch.solvers import ripm, riptrm

    for module in (riptrm, ripm):
        orig = module.make_step

        def patched(*args, orig=orig, **kwargs):
            step = orig(*args, **kwargs)
            return lambda state, *rest: (state, step(state, *rest)[1])

        monkeypatch.setattr(module, "make_step", patched)


def half_left_out(run, pool):
    """Only the first half of each call's lanes is solved; the rest come
    back as their starts, with the solved half's residuals."""
    def faulty(xs, ys):
        h = max(1, xs.shape[0] // 2)
        x, y, k, r = run(xs[:h], ys[:h])
        rest = xs.shape[0] - h
        return (torch.cat([x, xs[h:]]), torch.cat([y, ys[h:]]),
                torch.cat([k, torch.zeros_like(k[:1]).expand(rest)]),
                torch.cat([r, r[:1].expand(rest)]))

    return faulty


def answer_altered(run, pool):
    """The first lane's answer is moved by 1e-2 after it is produced."""
    def faulty(xs, ys):
        x, y, k, r = run(xs, ys)
        x = x.clone()
        x[0] = x[0] + 1e-2
        return x, y, k, r

    return faulty


@pytest.mark.parametrize("name", CELLS)
def test_step_returning_its_state(tiny_root, name, monkeypatch):
    step_unchanged(monkeypatch)
    out = rehearse(tiny_root, name, seconds=0.5)
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"]  # every lane left unmoved


@pytest.mark.parametrize("name", CELLS)
def test_half_the_lanes_left_out(tiny_root, name):
    out = rehearse(tiny_root, name, wrap=half_left_out)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= out["attempted"] // 2  # the half left out


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered(tiny_root, name):
    out = rehearse(tiny_root, name, wrap=answer_altered)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def tcg_image_altered(monkeypatch, cell):
    """The fused tCG's Hessian image comes back 10 % too long on every lane."""
    from riptrm_torch.ops import kernels

    name = cell.program.TCG_ENTRY
    entry = getattr(kernels, name)

    def faulty(*args, **kwargs):
        eta, heta, iters, codes = entry(*args, **kwargs)
        return eta, heta * 1.1, iters, codes

    monkeypatch.setattr(kernels, name, faulty)


@pytest.mark.parametrize("name", TCG_CELLS)
def test_tcg_image_altered(tiny_root, name, monkeypatch):
    tcg_image_altered(monkeypatch, harness.find_cell(name, tiny_root))
    out = rehearse(tiny_root, name)
    assert not out["correct"], out["checks"]
    assert out["checks"]["tcg_heta_gap"]["value"] > out["checks"]["tcg_heta_gap"]["limit"]

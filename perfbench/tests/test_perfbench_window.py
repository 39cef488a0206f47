"""The window's stop rule and the rate arithmetic, on synthetic call
times (a fake clock), and the judgement of lanes against tolresid."""

import types

import numpy as np
import pytest

from perfbench import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def fake_run(clock, durations, lanes):
    it = iter(durations)

    def run(xs, ys):
        clock.t += next(it)
        return xs, ys, np.full(lanes, 5), np.zeros(lanes)

    return run


@pytest.mark.parametrize("durations,seconds,expect", [
    ([15.0, 15.0, 15.0, 15.0], 51.0, 3),   # 6 s left < 15 s mean: stop at 45 s
    ([1.0] * 60, 10.0, 10),               # stops exactly at the window
    ([20.0, 1.0], 10.0, 1),               # the first call always runs
    ([2.0, 2.0, 8.0, 2.0], 13.0, 3),      # mean 4 s after 12 s: 1 s left
])
def test_stop_rule(monkeypatch, durations, seconds, expect):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    pool = np.zeros((4, 2, 3))
    calls, window = harness.closed_loop(fake_run(clock, durations, 2), pool, None, seconds,
                                        lambda: None)
    assert len(calls) == expect
    assert window == pytest.approx(sum(durations[:expect]))
    assert [c.index for c in calls] == list(range(expect))


def test_pool_cycles(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    pool = np.arange(3)[:, None, None] * np.ones((3, 2, 1))
    seen = []

    def run(xs, ys):
        seen.append(float(xs[0, 0]))
        clock.t += 1.0
        return xs, ys, np.ones(2), np.zeros(2)

    harness.closed_loop(run, pool, None, 5.0, lambda: None)
    assert seen == [0.0, 1.0, 2.0, 0.0, 1.0]


def test_rates():
    calls = [harness.Call(i, 0.0, s, None, None, np.full(4, 10 + i), None)
             for i, s in enumerate([1.0, 2.0, 3.0, 4.0])]
    run = types.SimpleNamespace(calls=calls, window_s=10.0, setup_s=3.5,
                                steps=[int(c.steps.max()) for c in calls])
    cell = harness.find_cell("nonnegpca-n50.ripm-sweep-b131072")
    read = lambda name: cell.piece("metrics", name).read(run)  # noqa: E731
    assert read("solves_per_s") == pytest.approx(16 / 10.0)
    assert read("setup_s") == 3.5
    assert read("solver.steps_per_sweep") == pytest.approx(11.5)



def test_in_place_of_shares_the_entrys_attributes():
    def entry(a):
        return a + 1

    entry.launches = 3
    stand_in = harness.in_place_of(entry, lambda a: a * 2)
    stand_in.launches += 1
    assert stand_in(5) == 10 and entry.launches == 4


def test_tcg_probe_records_the_first_call_only(monkeypatch):
    """Whatever the seed, the probe keeps the tCG entry's calls of the
    window's first call, on the sample's lanes that each call has."""
    import torch
    from riptrm_torch.ops import kernels

    def entry(zs, xs, radii):
        return xs * 2.0, radii + 1.0

    monkeypatch.setattr(kernels, "probe_test_entry", entry, raising=False)

    def run(xs, ys):  # two entry calls a window call, the second on 3 lanes
        kernels.probe_test_entry(None, xs, xs[:, 0])
        return kernels.probe_test_entry(None, xs[:3], xs[:3, 0])

    probe = harness.TcgProbe("probe_test_entry", torch.tensor([1, 4]))
    probed = probe.wrap(run)
    for i in range(3):
        probed(torch.full((5, 2), float(i)) + torch.arange(5.0)[:, None], None)
    assert kernels.probe_test_entry is entry and len(probe.records) == 2
    (args, _, out), (args3, _, out3) = probe.records
    assert args[1][:, 0].tolist() == [1.0, 4.0] and out[0][:, 0].tolist() == [2.0, 8.0]
    assert args3[1][:, 0].tolist() == [1.0] and out3[1].tolist() == [2.0]


@pytest.mark.parametrize("own, ref, ok", [
    ([0.9999, 0.5], [1.00005, 0.5], True),  # stops under tol, a hair over it in float64
    ([1.0001, 0.5], [1.0001, 0.5], False),  # stops over tol by its own test
    ([0.5, 0.5], [0.9, 0.5], False),  # own report 44 % under the reference's
])
def test_lanes_held_to_tol_by_their_own_test(own, ref, ok):
    attempted, failed, checks = judge_two_lanes(own, ref)
    assert attempted == 2 and failed == int(not ok)
    assert all(c["value"] <= c["limit"] for c in checks.values()) is ok


@pytest.mark.parametrize("own, ref, failed_lanes", [
    ([0.9999, 0.5], [1.0005, 0.5], 0),  # over tol in float64 by less than resid_gap
    ([1.01, 0.5], [1.01, 0.5], 1),  # over tol by its own test
    ([float("nan"), 0.5], [0.5, 0.5], 1),  # its own report not finite
    ([0.5, 0.5], [float("inf"), 0.5], 1),  # the reference's not finite
    ([0.9, 0.9], [0.9, 1.0], 1),  # the second lane's reports 10 % apart
])
def test_failed_counts_lanes_by_the_rule_of_correct(own, ref, failed_lanes):
    attempted, failed, checks = judge_two_lanes(own, ref)
    assert attempted == 2 and failed == failed_lanes
    assert all(c["value"] <= c["limit"] for c in checks.values()) is (failed_lanes == 0)


def judge_two_lanes(own, ref):
    """``harness.judge`` of one call of two lanes at tolresid 1 whose own
    residuals are ``own`` and the reference's ``ref``."""
    import torch

    x = torch.zeros(2, 3)
    pool = torch.ones(1, 2, 3)
    cell = types.SimpleNamespace(
        config={"solver": {"tolresid": 1.0}},
        checks={"numbers": {n: {"limit": lim} for n, lim in (
            ("resid_gap", 1e-2), ("lane_resid_over_tol", 1.0), ("unmoved_lanes", 0))}},
        reference=types.SimpleNamespace(
            residual=lambda arrays, cfg, x, y: torch.tensor(ref, dtype=torch.float64)))
    call = harness.Call(0, 0.0, 1.0, x, x, np.ones(2), torch.tensor(own))
    return harness.judge(cell, {}, [call], pool, [])

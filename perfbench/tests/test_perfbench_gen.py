"""The seeded generators repeat from a seed, differ across seeds, and
give strictly feasible starts."""

import numpy as np

from perfbench.gen import nonneg_pca
from perfbench.harness import rng_for

CFG = {"dim": 50, "snr": 0.5, "delta": 0.7}
SEED = 2**31 + 12345  # seeds may reach past 32 signed bits


def test_same_seed_same_inputs():
    def draw(seed):
        rng = rng_for(seed)
        return nonneg_pca.instance(rng, CFG)["Z"], nonneg_pca.starts(rng, CFG, 5)

    (z1, s1), (z2, s2), (z3, _) = draw(SEED), draw(SEED), draw(SEED + 1)
    assert np.array_equal(z1, z2) and np.array_equal(s1, s2)
    assert not np.array_equal(z1, z3)


def test_nonneg_starts_feasible_unit():
    s = nonneg_pca.starts(rng_for(SEED), CFG, 7)
    assert s.shape == (7, 50) and np.all(s > 0)
    assert np.allclose(np.linalg.norm(s, axis=1), 1.0)


def test_instance_is_the_configurations_and_starts_follow_the_seed(tiny_root):
    from perfbench import harness

    cell = harness.find_cell("nonnegpca-n50.riptrm-sweep-b131072", tiny_root)
    (a, s), (b, t), (_, u) = (harness.make_inputs(cell, seed) for seed in (SEED, SEED + 1, SEED))
    assert np.array_equal(a["Z"], b["Z"]) and np.array_equal(s, u)
    assert not np.array_equal(s, t)
    assert s.shape == (cell.traffic["pool_sweeps"], cell.traffic["lanes"], 40)


def test_tcg_sample_follows_the_seed():
    from perfbench.harness import tcg_sample

    mix = {"lanes": 1000, "tcg_sample_lanes": 64}
    a, b, c = tcg_sample(SEED, mix), tcg_sample(SEED, mix), tcg_sample(SEED + 1, mix)
    assert a.tolist() == b.tolist() and a.tolist() != c.tolist()
    assert len(set(a.tolist())) == 64 and a.tolist() == sorted(a.tolist()) and int(a.max()) < 1000
    assert tcg_sample(SEED, {"lanes": 4}).tolist() == [0, 1, 2, 3]

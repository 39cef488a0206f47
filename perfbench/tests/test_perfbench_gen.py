"""The seeded generators repeat from a seed, differ across seeds, and
give strictly feasible starts; a mix's fixed pool of starts is one
multiset for every seed."""

import dataclasses
import hashlib

import numpy as np
import pytest

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

    cell = harness.find_cell("nonnegpca-n50.ripm-sweep-b131072", tiny_root)
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


# sha256 of Z's bytes, then the starts' bytes, that the recipe before
# ``starts_pool`` gave for the RIPM cell at its full size
RIPM_INPUTS = {
    0: "2673d55ea71cc952337c486bdb30026bc40136c33ac3625268cb741725ef7473",
    SEED: "1e6e10e5b9fed7e9062524e2712977d2f8582a5550bcdebd20e8c78488961e49",
    3190019001: "46eb03666be2b480a7628111ec1f6bbef5c8bb54f22cba28cacd4d0477ea61bc",
}


@pytest.mark.parametrize("seed", sorted(RIPM_INPUTS))
def test_mix_without_starts_pool_draws_as_before(seed):
    from perfbench import harness

    cell = harness.find_cell("nonnegpca-n50.ripm-sweep-b131072")
    assert "starts_pool" not in cell.traffic
    arrays, starts = harness.make_inputs(cell, seed)
    assert starts.shape == (4, 131072, 50) and starts.dtype == np.float64
    digest = hashlib.sha256(arrays["Z"].tobytes())
    digest.update(np.ascontiguousarray(starts).tobytes())
    assert digest.hexdigest() == RIPM_INPUTS[seed]


def test_fixed_pool_is_one_multiset_in_orders_of_the_seed(tiny_root):
    from perfbench import harness

    cell = harness.find_cell("nonnegpca-n50.riptrm-sweep-b131072", tiny_root)
    assert cell.traffic["starts_pool"] == "fixed"
    cell = dataclasses.replace(cell, traffic=cell.traffic | {"lanes": 64})
    (a, s), (b, t), (_, u) = (harness.make_inputs(cell, seed) for seed in (SEED, SEED + 1, SEED))
    assert s.shape == (3, 64, 40) and np.array_equal(a["Z"], b["Z"]) and np.array_equal(s, u)
    for one, other in zip(s, t):
        assert np.array_equal(np.unique(one, axis=0), np.unique(other, axis=0))
        assert not np.array_equal(one, other)
        assert len(np.unique(one, axis=0)) == 64
    free = harness.make_inputs(dataclasses.replace(
        cell, traffic={k: v for k, v in cell.traffic.items() if k != "starts_pool"}), SEED)[1]
    assert not np.isin(free, s).any()  # the pool is not the seed's draw
    instance = nonneg_pca.starts(rng_for(cell.config["instance_seed"]), cell.config, 3 * 64)
    assert not np.isin(instance, s).any()  # nor the instance stream's
    with pytest.raises(ValueError, match="starts_pool"):
        harness.make_inputs(dataclasses.replace(
            cell, traffic=cell.traffic | {"starts_pool": "Fixed"}), SEED)

"""The port's default device: the card, never a silent fall back to the CPU.

With no ``device`` argument the problem constructors, ``random_point`` and
``state_from_numpy`` put their tensors on CUDA device 0
(``config.resolve``), and raise where CUDA is absent.  Whether CUDA is
present is decided inside each test by patching ``torch.cuda``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from riptrm_torch import config
from riptrm_torch.manifolds import Sphere, Stiefel
from riptrm_torch.problems import bounded_pca, nonneg_pca
from riptrm_torch.solvers import riptrm as trm

DATA = {"NonnegPCA": "dataset/NonnegPCA/1", "BoundedPCA": "dataset/BoundedPCA/1"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


ENTRY_POINTS = {
    "nonneg_pca.load_problem": lambda: nonneg_pca.load_problem(DATA["NonnegPCA"], "a"),
    "bounded_pca.load_problem": lambda: bounded_pca.load_problem(DATA["BoundedPCA"], "a"),
    "nonneg_pca.make_problem": lambda: nonneg_pca.make_problem(np.eye(3), np.ones(3)),
    "Sphere.random_point": lambda: Sphere(4).random_point(torch.Generator(), 2),
    "Stiefel.random_point": lambda: Stiefel(5, 2).random_point(torch.Generator(), 2),
    "state_from_numpy": lambda: trm.state_from_numpy(
        {f.name: np.zeros(1) for f in dataclasses.fields(trm.RiptrmState)}
    ),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_resolve_defaults_to_the_first_card(one_card):
    dtype, device = config.resolve()
    assert dtype == torch.float64
    assert device == torch.device("cuda", 0)


def test_explicit_cpu_needs_no_cuda(no_cuda):
    p = nonneg_pca.load_problem(DATA["NonnegPCA"], "a", device="cpu")
    assert p.x0.device.type == p.structure["Zs"].device.type == "cpu"
    assert config.resolve(torch.float32, "cpu") == (torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("man", [Sphere(6), Stiefel(6, 2)], ids=["sphere", "stiefel"])
def test_random_point_draws_on_the_generator_device(man, no_cuda):
    """A CPU generator feeds a draw on another device: the draw is made on
    the generator's device and moved, so the numbers are the CPU draw's."""
    on_meta = man.random_point(torch.Generator().manual_seed(3), 2, device="meta")
    on_cpu = man.random_point(torch.Generator().manual_seed(3), 2, device="cpu")
    assert on_meta.device.type == "meta" and on_meta.shape == on_cpu.shape
    again = man.random_point(torch.Generator().manual_seed(3), 2, device="cpu")
    torch.testing.assert_close(on_cpu, again, atol=0, rtol=0)

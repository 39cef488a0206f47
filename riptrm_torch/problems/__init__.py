from riptrm_torch.problems import (
    bounded_pca,
    embedded,
    low_rank,
    nonneg_pca,
    rosenbrock,
    stable_identification,
)
from riptrm_torch.problems.embedded import EmbeddedProblem, ambient_problem
from riptrm_torch.problems.problem import Problem

__all__ = ["EmbeddedProblem", "Problem", "ambient_problem", "bounded_pca", "embedded",
           "low_rank", "nonneg_pca", "rosenbrock", "stable_identification"]

from riptrm_torch.problems import bounded_pca, nonneg_pca
from riptrm_torch.problems.problem import Problem

__all__ = ["Problem", "bounded_pca", "nonneg_pca"]

from riptrm_torch.problems import nonneg_pca
from riptrm_torch.problems.problem import Problem

__all__ = ["Problem", "nonneg_pca"]

from riptrm_torch.solvers.riptrm import RIPTRM

__all__ = ["RIPTRM"]

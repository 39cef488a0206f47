from riptrm_torch.ops import kernels, kkt, tcg
from riptrm_torch.ops.kkt import compute_residual, evaluation
from riptrm_torch.ops.tcg import truncated_cg

__all__ = ["kernels", "kkt", "tcg", "compute_residual", "evaluation", "truncated_cg"]

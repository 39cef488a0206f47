from riptrm_torch.ops import basis, conjres, kernels, kkt, qp, spectrum, tcg, trs
from riptrm_torch.ops.kkt import compute_residual, evaluation
from riptrm_torch.ops.tcg import truncated_cg

__all__ = ["basis", "conjres", "kernels", "kkt", "qp", "spectrum", "tcg", "trs",
           "compute_residual", "evaluation", "truncated_cg"]

from riptrm_torch.solvers.ralm import RALM
from riptrm_torch.solvers.ripm import RIPM
from riptrm_torch.solvers.riptrm import RIPTRM
from riptrm_torch.solvers.rsqo import RSQO

__all__ = ["RALM", "RIPM", "RIPTRM", "RSQO"]

from riptrm_torch.utils.devices import cuda_device
from riptrm_torch.utils.io import loadtxt, savetxt

__all__ = ["cuda_device", "loadtxt", "savetxt"]

from riptrm_torch.manifolds.base import Manifold
from riptrm_torch.manifolds.sphere import Sphere

__all__ = ["Manifold", "Sphere"]

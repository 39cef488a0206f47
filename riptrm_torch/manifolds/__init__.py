from riptrm_torch.manifolds.base import Manifold, skew, sym
from riptrm_torch.manifolds.euclidean import Euclidean
from riptrm_torch.manifolds.sphere import Sphere
from riptrm_torch.manifolds.stiefel import Stiefel

__all__ = ["Euclidean", "Manifold", "Sphere", "Stiefel", "skew", "sym"]

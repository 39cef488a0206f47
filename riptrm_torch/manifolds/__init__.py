from riptrm_torch.manifolds.base import Manifold, skew, sym
from riptrm_torch.manifolds.euclidean import Euclidean, SkewSymmetric, Symmetric
from riptrm_torch.manifolds.fixed_rank import FixedRankEmbedded
from riptrm_torch.manifolds.grassmann import Grassmann
from riptrm_torch.manifolds.product import Product
from riptrm_torch.manifolds.spd import SymmetricPositiveDefinite
from riptrm_torch.manifolds.sphere import Sphere
from riptrm_torch.manifolds.stiefel import Stiefel

__all__ = [
    "Euclidean",
    "FixedRankEmbedded",
    "Grassmann",
    "Manifold",
    "Product",
    "SkewSymmetric",
    "Sphere",
    "Stiefel",
    "Symmetric",
    "SymmetricPositiveDefinite",
    "skew",
    "sym",
]

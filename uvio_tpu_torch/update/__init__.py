from .msckf import msckf_update
from .triangulation import triangulate_batch

__all__ = ["msckf_update", "triangulate_batch"]

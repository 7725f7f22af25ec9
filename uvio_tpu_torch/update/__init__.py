from .msckf import msckf_update
from .triangulation import refine_gauss_newton, triangulate_batch, triangulate_linear

__all__ = ["msckf_update", "refine_gauss_newton", "triangulate_batch", "triangulate_linear"]

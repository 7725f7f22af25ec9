from .models import EQUI, RADTAN, distort, distort_jacobian, project, undistort

__all__ = ["EQUI", "RADTAN", "distort", "distort_jacobian", "project", "undistort"]

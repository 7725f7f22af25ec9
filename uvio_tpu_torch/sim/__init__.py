from .simulator import (
    SimCamera,
    SimParams,
    Simulator,
    circle_trajectory,
    load_tum_trajectory,
    perturb_calibration,
)

__all__ = [
    "SimCamera",
    "SimParams",
    "Simulator",
    "circle_trajectory",
    "load_tum_trajectory",
    "perturb_calibration",
]

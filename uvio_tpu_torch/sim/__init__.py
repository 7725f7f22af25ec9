from .simulator import SimCamera, SimParams, Simulator, circle_trajectory

__all__ = ["SimCamera", "SimParams", "Simulator", "circle_trajectory"]

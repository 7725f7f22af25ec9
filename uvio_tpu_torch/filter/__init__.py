from .ekf import (
    augment_clone,
    ekf_update,
    initialize_invertible_block,
    inject,
    marginalize_clone,
    marginalize_slam,
    propagate_covariance,
    set_block_covariance,
)
from .propagator import (
    NoiseManager,
    propagate_and_clone,
    propagate_mean_cov,
    select_imu_readings_np,
)

__all__ = [
    "NoiseManager",
    "augment_clone",
    "ekf_update",
    "initialize_invertible_block",
    "inject",
    "marginalize_clone",
    "marginalize_slam",
    "propagate_and_clone",
    "propagate_covariance",
    "propagate_mean_cov",
    "select_imu_readings_np",
    "set_block_covariance",
]

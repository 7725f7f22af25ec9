from .ekf import augment_clone, ekf_update, inject, marginalize_clone, propagate_covariance
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
    "inject",
    "marginalize_clone",
    "propagate_and_clone",
    "propagate_covariance",
    "propagate_mean_cov",
    "select_imu_readings_np",
]

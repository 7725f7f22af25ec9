"""Static (stationary) initialization.

Equivalent of `ov_init/src/static/StaticInitializer.cpp:37-165` plus the
dispatcher windowing of `ov_init/src/init/InertialInitializer.cpp:73-147`:
split the IMU buffer into two half-windows; require the older half to be
still (low accel variance) and — in jerk mode — the newer half to show a
jerk; then recover gravity-aligned orientation by Gram-Schmidt, set
biases from the still-window means, and seed a fixed prior covariance.

Port of `uvio_tpu/init/static_init.py`. Host-side numpy: runs once at
startup on a small buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..math import quat_to_rot, rot_to_quat


@dataclasses.dataclass
class StaticInitOptions:
    window_time: float = 2.0  # init_window_time
    imu_thresh: float = 1.5  # accel std-dev threshold for jerk detect
    wait_for_jerk: bool = True
    gravity_mag: float = 9.81


@dataclasses.dataclass
class StaticInitResult:
    time: float
    q_GtoI: np.ndarray
    p: np.ndarray
    v: np.ndarray
    bg: np.ndarray
    ba: np.ndarray
    prior_std: np.ndarray  # (15,) error-state std-devs


def gravity_aligned_quat(a_avg: np.ndarray) -> np.ndarray:
    """JPL q_GtoI whose rotation maps global +z onto the measured
    gravity direction in the IMU frame (gram_schmidt, helper.h)."""
    z = a_avg / np.linalg.norm(a_avg)
    e1 = np.array([1.0, 0.0, 0.0])
    x = e1 - z * (z @ e1)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R_GtoI = np.stack([x, y, z], axis=1)  # columns
    return rot_to_quat(torch.as_tensor(R_GtoI)).numpy()


def try_static_init(
    imu_t: np.ndarray,
    imu_w: np.ndarray,
    imu_a: np.ndarray,
    opts: StaticInitOptions,
) -> Optional[StaticInitResult]:
    """Attempt initialization from the IMU buffer; None if not ready."""
    if len(imu_t) < 10:
        return None
    # the reference splits ONE init window into two halves
    # (StaticInitializer.cpp:78-92: window_2to1 = [t-w, t-w/2],
    # window_1to0 = [t-w/2, t]), so init needs `window_time` of data,
    # not 2x — this halves the init latency
    t_new = imu_t[-1]
    t_mid = t_new - 0.5 * opts.window_time
    t_old = t_new - opts.window_time
    if t_new - imu_t[0] < opts.window_time:
        return None  # buffer too short (StaticInitializer.cpp:50)
    # exact reference boundaries (StaticInitializer.cpp:56-64):
    # window_2to1 = (t-w, t-w/2], window_1to0 = (t-w/2, t]
    sel1 = (imu_t > t_old) & (imu_t <= t_mid)  # older window
    sel2 = imu_t > t_mid  # newer window
    if sel1.sum() < 2 or sel2.sum() < 2:
        return None
    a1, a2 = imu_a[sel1], imu_a[sel2]
    w1 = imu_w[sel1]
    # sample std-dev with the reference's n-1 normalization
    # (StaticInitializer.cpp:82, 99)
    var1 = np.sqrt(np.sum((a1 - a1.mean(0)) ** 2) / (len(a1) - 1))
    var2 = np.sqrt(np.sum((a2 - a2.mean(0)) ** 2) / (len(a2) - 1))
    if var1 > opts.imu_thresh:
        return None  # too much motion in the "still" window
    if opts.wait_for_jerk and var2 < opts.imu_thresh:
        return None  # no jerk yet
    if not opts.wait_for_jerk and var2 > opts.imu_thresh:
        return None  # want stillness throughout
    a_avg = a1.mean(0)
    w_avg = w1.mean(0)
    q = gravity_aligned_quat(a_avg)
    R_GtoI = quat_to_rot(torch.as_tensor(q)).numpy()
    gravity = np.array([0.0, 0.0, opts.gravity_mag])
    ba = a_avg - R_GtoI @ gravity
    # the reference's fixed startup covariance
    # (StaticInitializer.cpp:146-151: q 0.02, p 0.05, v 0.01, biases
    # 0.02 — yaw/position left soft, not gauge-pinned)
    prior_std = np.concatenate(
        [
            np.full(3, 0.02),  # q (incl. yaw)
            np.full(3, 0.05),  # p
            np.full(3, 0.01),  # v
            np.full(3, 0.02),  # bg
            np.full(3, 0.02),  # ba
        ]
    )
    # initialize at the end of the STILL window in both modes like the
    # reference (timestamp = window_2to1.back(), StaticInitializer.cpp:134)
    t0 = float(imu_t[sel1][-1])
    return StaticInitResult(
        time=t0,
        q_GtoI=q,
        p=np.zeros(3),
        v=np.zeros(3),
        bg=w_avg,
        ba=ba,
        prior_std=prior_std,
    )

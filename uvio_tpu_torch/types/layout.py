"""Static error-state layout.

The reference tracks covariance indices dynamically on pointer-based
`Type` objects (`ov_core/src/types/Type.h` `set_local_id`, and
`StateHelper::marginalize` physically deletes matrix blocks). On TPU the
state layout must be static: this module fixes, per configuration, a
flat error-state vector of dimension `dim`:

    [ imu(15) | imu_intr(0|15|24) | calib | clones(6*K) | slam(3*S) | anchors(5*A) ]

with presence masks in the mean pytree instead of insertion/deletion:

  * the clone window is a *slot ring buffer* — marginalizing the oldest
    clone frees its slot and the next stochastic clone overwrites that
    slot's covariance rows/columns (no resize, no permutation);
  * SLAM landmarks and UWB anchors are slot pools with valid masks.

imu error order (matches the reference IMU type, `ov_core/src/types/IMU.h`):
theta(3) p(3) v(3) bg(3) ba(3). Clone error: theta(3) p(3) (PoseJPL).
Anchor error: p_AinG(3) const_bias(1) dist_bias(1) (`uvio/src/types/
UWB_anchor.h`).

IMU intrinsics (scale/misalignment/g-sensitivity calibration,
`State::Dm/Tg`, `State.h:91-135`): when `calib_imu_intrinsics` the
error state gains dw(6) da(6) [tg(9) if g-sensitivity] theta_imu(3),
placed DIRECTLY after the 15-dof IMU block so propagation touches one
contiguous leading block. theta_imu is the gyro-to-IMU frame rotation
for the KALIBR model and the acc-to-IMU rotation for RPNG (the
reference estimates exactly one per model, `Propagator.cpp:836-870`).
"""

from __future__ import annotations

import dataclasses

IMU_MODEL_KALIBR = 0
IMU_MODEL_RPNG = 1


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Static sizes and error-state index bookkeeping (hashable)."""

    max_clones: int = 11
    max_slam: int = 0
    max_anchors: int = 0
    num_cams: int = 1
    # calibration states included in the error state
    calib_cam_timeoffset: bool = False
    calib_cam_pose: bool = False
    calib_cam_intrinsics: bool = False
    calib_uwb_extrinsics: bool = False
    # IMU intrinsic calibration (Dw/Da scale+misalignment, optional Tg
    # g-sensitivity, one gyro/acc frame rotation per model)
    calib_imu_intrinsics: bool = False
    calib_imu_g_sensitivity: bool = False
    imu_model: int = IMU_MODEL_KALIBR
    # SLAM landmark representation (update/representations.py constants:
    # 0 = GLOBAL_3D, 1 = ANCHORED_MSCKF_INVERSE_DEPTH)
    slam_rep: int = 0
    # max IMU samples handed to one propagation call (padded)
    max_imu_batch: int = 32

    # ---- error-state offsets ----
    @property
    def imu_off(self) -> int:
        return 0

    @property
    def theta_off(self) -> int:
        return 0

    @property
    def p_off(self) -> int:
        return 3

    @property
    def v_off(self) -> int:
        return 6

    @property
    def bg_off(self) -> int:
        return 9

    @property
    def ba_off(self) -> int:
        return 12

    # ---- IMU intrinsics block (directly after the IMU block) ----
    @property
    def imu_intr_off(self) -> int:
        return 15

    @property
    def imu_dw_off(self) -> int:
        return 15

    @property
    def imu_da_off(self) -> int:
        return 21

    @property
    def imu_tg_off(self) -> int:
        return 27

    @property
    def imu_theta_off(self) -> int:
        """Gyro-to-IMU (kalibr) / acc-to-IMU (rpng) rotation error."""
        return 27 + (9 if self.calib_imu_g_sensitivity else 0)

    @property
    def imu_intr_dim(self) -> int:
        if not self.calib_imu_intrinsics:
            return 0
        return 15 + (9 if self.calib_imu_g_sensitivity else 0)

    @property
    def calib_off(self) -> int:
        return 15 + self.imu_intr_dim

    @property
    def calib_dt_off(self) -> int:
        """Camera-IMU time offset (1 dof), if calibrated."""
        return self.calib_off

    @property
    def calib_cam_pose_off(self) -> int:
        return self.calib_off + (1 if self.calib_cam_timeoffset else 0)

    @property
    def calib_cam_intr_off(self) -> int:
        return self.calib_cam_pose_off + (6 * self.num_cams if self.calib_cam_pose else 0)

    @property
    def calib_uwb_off(self) -> int:
        """UWB-IMU lever arm p_IinU (3 dof), if calibrated."""
        return self.calib_cam_intr_off + (8 * self.num_cams if self.calib_cam_intrinsics else 0)

    @property
    def calib_dim(self) -> int:
        d = 0
        if self.calib_cam_timeoffset:
            d += 1
        if self.calib_cam_pose:
            d += 6 * self.num_cams
        if self.calib_cam_intrinsics:
            d += 8 * self.num_cams
        if self.calib_uwb_extrinsics:
            d += 3
        return d

    @property
    def clone_off(self) -> int:
        return self.calib_off + self.calib_dim

    def clone_slot_off(self, k) -> int:
        """Offset of clone slot k (k may be traced; returns traced int)."""
        return self.clone_off + 6 * k

    @property
    def slam_off(self) -> int:
        return self.clone_off + 6 * self.max_clones

    def slam_slot_off(self, s) -> int:
        return self.slam_off + 3 * s

    @property
    def anchor_off(self) -> int:
        return self.slam_off + 3 * self.max_slam

    def anchor_slot_off(self, a) -> int:
        return self.anchor_off + 5 * a

    @property
    def dim(self) -> int:
        return self.anchor_off + 5 * self.max_anchors

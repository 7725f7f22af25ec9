"""Config loader for the reference's YAML layout.

Port of `uvio_tpu/utils/config.py`, returning the port's configuration
classes. Reads the exact on-disk format of the reference
(`ov_core/src/utils/opencv_yaml_parse.h` consumer side): a master
`estimator_config.yaml` plus relative `kalibr_imu_chain.yaml`,
`kalibr_imucam_chain.yaml`, and (UVIO) `uwb_config.yaml` /
`uwb_anchors.yaml` — so a user of the reference can point this
framework at their existing `config/<dataset>/` directory unchanged.

OpenCV-YAML quirks handled: the `%YAML:1.0` directive (invalid for
pyyaml) is stripped; `T_imu_cam` rows are `[R_CtoI | p_CinI]`
(converted to our `q_ItoC`, `p_IinC`); `p_UinI` is negated into the
state's `p_IinU` lever arm (`UVioManagerOptions.h:57-64` sign
convention).

`load_config(..., device=)` stores the device in the configuration, so a
manager built from it runs on the card by default like every other
entry point of the port (None is `default_device()`). The managers are
imported where they are used: `manager.py` imports this package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import yaml

from ..cam import EQUI, RADTAN
from ..filter.propagator import NoiseManager
from ..init.dynamic_init import DynamicInitOptions
from ..init.static_init import StaticInitOptions
from ..math import rot_to_quat


def _quat(R: np.ndarray) -> np.ndarray:
    """JPL quaternion of a rotation matrix, on the CPU."""
    return rot_to_quat(torch.as_tensor(np.asarray(R, dtype=np.float64))).numpy()


def _load_yaml(path: str):
    with open(path) as f:
        text = f.read()
    lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
    return yaml.safe_load("\n".join(lines)) or {}


def _parse_cameras(cam_chain: dict, max_cameras: int):
    from ..manager import CameraConfig

    cams = []
    for i in range(max_cameras):
        key = f"cam{i}"
        if key not in cam_chain:
            break
        c = cam_chain[key]
        if "T_imu_cam" in c:
            T = np.asarray(c["T_imu_cam"], dtype=float)  # [R_CtoI | p_CinI]
            R_ItoC = T[:3, :3].T
            p_IinC = -R_ItoC @ T[:3, 3]
        else:
            T = np.asarray(c["T_cam_imu"], dtype=float)  # [R_ItoC | p_IinC]
            R_ItoC = T[:3, :3]
            p_IinC = T[:3, 3]
        q_ItoC = _quat(R_ItoC)
        model = RADTAN if c.get("distortion_model", "radtan") == "radtan" else EQUI
        intr = np.concatenate(
            [np.asarray(c["intrinsics"], float), np.asarray(c["distortion_coeffs"], float)]
        )
        cams.append(
            CameraConfig(model=model, intrinsics=intr, q_ItoC=q_ItoC, p_IinC=p_IinC)
        )
    return cams


def _parse_imu_intrinsics(cfg, imu0):
    """kalibr imu-chain intrinsics -> VioConfig fields.

    Mirrors `VioManagerOptions.h:306-350`: Dw = Tw^-1, Da = Ta^-1,
    R_GYROtoIMU = R_IMUtoGYRO^T, triangular vec extraction per model,
    Tg column-wise."""
    model_s = str(imu0.get("model", "kalibr")).lower()
    model = 1 if model_s == "rpng" else 0
    out = dict(
        calib_imu_intrinsics=bool(cfg.get("calib_imu_intrinsics", False)),
        calib_imu_g_sensitivity=bool(cfg.get("calib_imu_g_sensitivity", False)),
        imu_model=model,
    )

    def mat(key):
        v = imu0.get(key)
        return None if v is None else np.asarray(v, float)

    Tw, Ta, Tg = mat("Tw"), mat("Ta"), mat("Tg")
    R_ItoG, R_ItoA = mat("R_IMUtoGYRO"), mat("R_IMUtoACC")

    def dm_vec(T):
        D = np.linalg.inv(T)
        if model == 0:  # kalibr lower triangle, column-wise
            return np.array([D[0, 0], D[1, 0], D[2, 0], D[1, 1], D[2, 1], D[2, 2]])
        return np.array([D[0, 0], D[0, 1], D[1, 1], D[0, 2], D[1, 2], D[2, 2]])

    if Tw is not None:
        out["imu_dw"] = dm_vec(Tw)
    if Ta is not None:
        out["imu_da"] = dm_vec(Ta)
    if Tg is not None:
        out["imu_tg"] = np.asarray(Tg).T.reshape(-1)  # column-wise 9-vector
    if R_ItoG is not None:
        out["imu_gq"] = _quat(R_ItoG.T)
    if R_ItoA is not None:
        out["imu_aq"] = _quat(R_ItoA.T)
    return out


def _parse_dyn_init(cfg):
    """Dynamic-init knob block (`InertialInitializerOptions.h:64-116`).

    `init_dyn_mle_max_threads` / `init_dyn_mle_max_time` are ceres
    runtime caps with no analog here (the MLE is a fixed-iteration
    Gauss-Newton) and are intentionally not mapped.
    """
    d = DynamicInitOptions()
    return DynamicInitOptions(
        num_pose=int(cfg.get("init_dyn_num_pose", d.num_pose)),
        max_features=int(cfg.get("init_max_features", d.max_features)),
        gn_iters=int(cfg.get("init_dyn_mle_max_iter", d.gn_iters)),
        min_deg=float(cfg.get("init_dyn_min_deg", d.min_deg)),
        min_rec_cond=float(cfg.get("init_dyn_min_rec_cond", d.min_rec_cond)),
        # shipped yamls use the short spellings (estimator_config.yaml),
        # the options header documents the long ones — accept both
        inflation_ori=float(
            cfg.get(
                "init_dyn_inflation_ori",
                cfg.get("init_dyn_inflation_orientation", d.inflation_ori),
            )
        ),
        inflation_vel=float(
            cfg.get(
                "init_dyn_inflation_vel",
                cfg.get("init_dyn_inflation_velocity", d.inflation_vel),
            )
        ),
        inflation_bg=float(
            cfg.get(
                "init_dyn_inflation_bg",
                cfg.get("init_dyn_inflation_bias_gyro", d.inflation_bg),
            )
        ),
        inflation_ba=float(
            cfg.get(
                "init_dyn_inflation_ba",
                cfg.get("init_dyn_inflation_bias_accel", d.inflation_ba),
            )
        ),
        init_bias_g=np.asarray(cfg.get("init_dyn_bias_g", [0.0, 0.0, 0.0]), float),
        init_bias_a=np.asarray(cfg.get("init_dyn_bias_a", [0.0, 0.0, 0.0]), float),
        mle_opt_calib=bool(cfg.get("init_dyn_mle_opt_calib", False)),
        gravity_mag=float(cfg.get("gravity_mag", d.gravity_mag)),
    )


def load_config(config_path: str, device=None):
    """Load `estimator_config.yaml` (or its directory) into a VioConfig
    (or UVioConfig when a uwb_config.yaml is present), with `device` as
    its device.

    Returns (config, extras) where extras carries values the manager
    does not consume directly (update_rate, resolution, topics...).
    """
    from ..manager import CameraConfig, VioConfig
    from ..uwb_manager import AnchorConfig, UVioConfig

    if os.path.isdir(config_path):
        config_path = os.path.join(config_path, "estimator_config.yaml")
    base = os.path.dirname(config_path)
    cfg = _load_yaml(config_path)

    # global print level from the config, like the reference's
    # `verbosity` yaml key (`print.h` Printer::setPrintLevel)
    if "verbosity" in cfg:
        from .logger import set_verbosity

        set_verbosity(str(cfg["verbosity"]))

    imu_chain = _load_yaml(
        os.path.join(base, cfg.get("relative_config_imu", "kalibr_imu_chain.yaml"))
    )
    cam_chain = _load_yaml(
        os.path.join(base, cfg.get("relative_config_imucam", "kalibr_imucam_chain.yaml"))
    )
    imu0 = imu_chain.get("imu0", {})
    noises = NoiseManager(
        sigma_w=float(imu0.get("gyroscope_noise_density", 1.6968e-4)),
        sigma_wb=float(imu0.get("gyroscope_random_walk", 1.9393e-5)),
        sigma_a=float(imu0.get("accelerometer_noise_density", 2.0e-3)),
        sigma_ab=float(imu0.get("accelerometer_random_walk", 3.0e-3)),
    )
    max_cams = int(cfg.get("max_cameras", 1))
    cameras = _parse_cameras(cam_chain, max_cams)
    if not cameras:
        cameras = [CameraConfig()]

    feat_rep = {
        "GLOBAL_3D": 0,
        "ANCHORED_MSCKF_INVERSE_DEPTH": 1,
        "ANCHORED_3D": 2,
        "GLOBAL_FULL_INVERSE_DEPTH": 3,
        "ANCHORED_FULL_INVERSE_DEPTH": 4,
        "ANCHORED_INVERSE_DEPTH_SINGLE": 5,
    }.get(str(cfg.get("feat_rep_slam", "ANCHORED_MSCKF_INVERSE_DEPTH")), 1)

    common = dict(
        max_clones=int(cfg.get("max_clones", 11)),
        max_slam=int(cfg.get("max_slam", 0)),
        dt_slam_delay=float(cfg.get("dt_slam_delay", 2.0)),
        feat_rep_slam=feat_rep,
        max_msckf_in_update=int(cfg.get("max_msckf_in_update", 40)),
        gravity_mag=float(cfg.get("gravity_mag", 9.81)),
        sigma_pix=float(cfg.get("up_msckf_sigma_px", 1.0)),
        chi2_mult=float(cfg.get("up_msckf_chi2_multipler", 1.0)),
        noises=noises,
        cameras=cameras,
        calib_cam_pose=bool(cfg.get("calib_cam_extrinsics", False)),
        calib_cam_intrinsics=bool(cfg.get("calib_cam_intrinsics", False)),
        calib_cam_timeoffset=bool(cfg.get("calib_cam_timeoffset", False)),
        camimu_dt=float(cfg.get("calib_camimu_dt", 0.0)),
        integration=str(cfg.get("integration", "rk4")).lower(),
        try_zupt=bool(cfg.get("try_zupt", False)),
        zupt_chi2_mult=float(cfg.get("zupt_chi2_multipler", 1.0)) or 1.0,
        zupt_max_velocity=float(cfg.get("zupt_max_velocity", 0.1)),
        zupt_noise_mult=float(cfg.get("zupt_noise_multiplier", 10.0)),
        zupt_max_disparity=float(cfg.get("zupt_max_disparity", 0.5)),
        zupt_only_at_beginning=bool(cfg.get("zupt_only_at_beginning", False)),
        # the reference hardcodes explicitly_enforce_zero_motion=false
        # (`UpdaterZeroVelocity.cpp:114`); exposed here as a yaml knob
        zupt_explicit=bool(cfg.get("zupt_explicitly_enforce_zero_motion", False)),
        init_options=StaticInitOptions(
            window_time=float(cfg.get("init_window_time", 2.0)),
            imu_thresh=float(cfg.get("init_imu_thresh", 1.5)),
            gravity_mag=float(cfg.get("gravity_mag", 9.81)),
            # extension knob (no reference yaml equivalent): false =
            # initialize during stillness instead of at motion onset
            wait_for_jerk=bool(cfg.get("init_wait_for_jerk", True)),
        ),
        init_max_disparity=float(cfg.get("init_max_disparity", 10.0)),
        use_dynamic_init=bool(cfg.get("init_dyn_use", False)),
        dyn_init_options=_parse_dyn_init(cfg),
        device=device,
    )
    common.update(_parse_imu_intrinsics(cfg, imu0))

    extras = {
        "num_pts": int(cfg.get("num_pts", 150)),
        "fast_threshold": float(cfg.get("fast_threshold", 20.0)),
        "grid_x": int(cfg.get("grid_x", 5)),
        "grid_y": int(cfg.get("grid_y", 5)),
        "use_klt": bool(cfg.get("use_klt", True)),
        "use_stereo": bool(cfg.get("use_stereo", False)),
        "update_rate": float(imu0.get("update_rate", 200.0)),
        "cam_timeoffset": float(cfg.get("calib_camimu_dt", 0.0)),
        "max_slam_in_update": int(cfg.get("max_slam_in_update", 25)),
    }

    # the reference's estimator_config key is `config_uwb`
    # (UVioManagerOptions.h parse_external("config_uwb", ...))
    uwb_path = os.path.join(
        base, cfg.get("config_uwb", cfg.get("relative_config_uwb", "uwb_config.yaml"))
    )
    if os.path.exists(uwb_path):
        uwb = _load_yaml(uwb_path)
        tag = uwb.get("tag0", {})
        init = uwb.get("init", {})
        anchors = []
        n_known = int(init.get("n_known_anchors", 0))
        # known anchors are expressed relative to the UAV's initial
        # position (UVioManagerOptions.h: p_AinG = pos - p_IinG0)
        p_IinG0 = np.asarray(tag.get("p_IinG0", [0.0, 0.0, 0.0]), float)
        anchors_path = os.path.join(base, "uwb_anchors.yaml")
        if n_known > 0 and os.path.exists(anchors_path):
            adata = _load_yaml(anchors_path)
            for k, a in adata.items():
                if not str(k).startswith("anchor"):
                    continue
                anchors.append(
                    AnchorConfig(
                        anchor_id=int(a["id"]),
                        p_AinG=np.asarray(a["p_AinG"], float) - p_IinG0,
                        gamma=float(a.get("const_bias", 0.0)),
                        alpha=float(a.get("dist_bias", 0.0)),
                        fix=bool(a.get("fix", False)),
                        prior_cov=np.diag(
                            [float(a.get("prior_p_AinG_cov", 0.05))] * 3
                            + [
                                float(a.get("prior_const_bias_cov", 0.2)),
                                float(a.get("prior_dist_bias_cov", 0.02)),
                            ]
                        ),
                    )
                )
        p_UinI = np.asarray(tag.get("p_UinI", [0.0, 0.0, 0.0]), float)
        out = UVioConfig(
            **common,
            max_anchors=max(8, len(anchors)),
            anchors=anchors,
            sigma_range=float(tag.get("uwb_sigma_range", 0.1)),
            uwb_chi2_mult=float(tag.get("uwb_chi2_multipler", 1.0)),
            min_dist_to_use_uwb=float(init.get("min_dist_to_use_uwb", 0.0)),
            calib_uwb_extrinsics=bool(tag.get("calib_uwb_extrinsics", False)),
            p_IinU=-p_UinI,
            p_IinU_prior_std=float(tag.get("prior_uwb_imu_cov", 0.1)) ** 0.5,
        )
        extras["n_fixed_anchors"] = int(init.get("n_fixed_anchors", 0))
        return out, extras

    return VioConfig(**common), extras

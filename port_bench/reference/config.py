"""The estimator's configuration, read from its YAML files as OpenVINS and
UVIO state it: `estimator_config.yaml`, the Kalibr chains it names, and
UVIO's `uwb_config.yaml` / `uwb_anchors.yaml`.

Only what the benchmark's estimator and simulator need is read, and
`supported()` names every setting that the plain reference does not
implement, so a configuration it cannot follow is refused instead of
judged by different arithmetic.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import yaml


@dataclasses.dataclass
class Camera:
    model: str  # "radtan" or "equidistant"
    intrinsics: np.ndarray  # fx fy cx cy k1 k2 p1 p2
    R_ItoC: np.ndarray
    p_IinC: np.ndarray


@dataclasses.dataclass
class Anchor:
    anchor_id: int
    p_AinG: np.ndarray
    gamma: float  # constant range bias
    alpha: float  # range bias per metre
    fix: bool
    prior_var: np.ndarray  # (5,) p_AinG (3), gamma, alpha


@dataclasses.dataclass
class EstimatorConfig:
    raw: dict  # estimator_config.yaml as read
    cameras: List[Camera]
    sigma_w: float
    sigma_wb: float
    sigma_a: float
    sigma_ab: float
    gravity_mag: float
    max_clones: int
    max_msckf_in_update: int
    sigma_pix: float
    chi2_mult: float
    # UWB (absent without a uwb_config.yaml)
    anchors: List[Anchor] = dataclasses.field(default_factory=list)
    sigma_range: float = 0.1
    uwb_chi2_mult: float = 1.0
    min_dist_to_use_uwb: float = 0.0
    calib_uwb_extrinsics: bool = False
    p_IinU: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    p_IinU_prior_var: float = 0.1

    def supported(self) -> List[str]:
        """The settings the plain reference does not implement (empty when
        it follows this configuration whole)."""
        r = self.raw
        off = ("calib_cam_extrinsics", "calib_cam_intrinsics", "calib_cam_timeoffset", "calib_imu_intrinsics",
               "calib_imu_g_sensitivity", "try_zupt", "use_stereo")
        out = [k for k in off if r.get(k, False)]
        if int(r.get("max_slam", 0)) > 0:
            out.append("max_slam")
        if str(r.get("integration", "rk4")).lower() != "rk4":
            out.append("integration")
        if not r.get("use_fej", True):
            out.append("use_fej")
        if float(r.get("calib_camimu_dt", 0.0)) != 0.0:
            out.append("calib_camimu_dt")
        if str(r.get("feat_rep_msckf", "GLOBAL_3D")) != "GLOBAL_3D":
            out.append("feat_rep_msckf")
        if len(self.cameras) != 1 or self.cameras[0].model != "radtan":
            out.append("cameras")
        if any(a.fix for a in self.anchors):
            out.append("fixed anchors")
        return out


def _yaml(path: str) -> dict:
    with open(path) as f:
        text = "\n".join(line for line in f.read().splitlines() if not line.startswith("%YAML"))
    return yaml.safe_load(text) or {}


def load(directory: str) -> EstimatorConfig:
    """The configuration in `directory` (its estimator_config.yaml)."""
    raw = _yaml(os.path.join(directory, "estimator_config.yaml"))
    imu = _yaml(os.path.join(directory, raw.get("relative_config_imu", "kalibr_imu_chain.yaml"))).get("imu0", {})
    for key, ident in (("Tw", np.eye(3)), ("Ta", np.eye(3)), ("R_IMUtoGYRO", np.eye(3)), ("R_IMUtoACC", np.eye(3)),
                       ("Tg", np.zeros((3, 3)))):
        if key in imu and not np.array_equal(np.asarray(imu[key], float), ident):
            raise ValueError(f"the reference models an ideal IMU; {key} is not")
    chain = _yaml(os.path.join(directory, raw.get("relative_config_imucam", "kalibr_imucam_chain.yaml")))
    cameras = []
    for i in range(int(raw.get("max_cameras", 1))):
        c = chain.get(f"cam{i}")
        if c is None:
            break
        T = np.asarray(c["T_imu_cam"], float)  # [R_CtoI | p_CinI]
        R_ItoC = T[:3, :3].T
        cameras.append(Camera(c.get("distortion_model", "radtan"),
                              np.concatenate([np.asarray(c["intrinsics"], float),
                                              np.asarray(c["distortion_coeffs"], float)]),
                              R_ItoC, -R_ItoC @ T[:3, 3]))
    cfg = EstimatorConfig(
        raw=raw, cameras=cameras,
        sigma_w=float(imu["gyroscope_noise_density"]), sigma_wb=float(imu["gyroscope_random_walk"]),
        sigma_a=float(imu["accelerometer_noise_density"]), sigma_ab=float(imu["accelerometer_random_walk"]),
        gravity_mag=float(raw.get("gravity_mag", 9.81)), max_clones=int(raw.get("max_clones", 11)),
        max_msckf_in_update=int(raw.get("max_msckf_in_update", 40)),
        sigma_pix=float(raw.get("up_msckf_sigma_px", 1.0)), chi2_mult=float(raw.get("up_msckf_chi2_multipler", 1.0)))
    uwb_path = os.path.join(directory, raw.get("config_uwb", "uwb_config.yaml"))
    if os.path.exists(uwb_path):
        u = _yaml(uwb_path)
        tag, init = u.get("tag0", {}), u.get("init", {})
        origin = np.asarray(tag.get("p_IinG0", [0.0, 0.0, 0.0]), float)
        anchors = []
        if int(init.get("n_known_anchors", 0)) > 0:
            for key, a in _yaml(os.path.join(directory, raw.get("uwb_anchors", "uwb_anchors.yaml"))).items():
                if str(key).startswith("anchor"):
                    anchors.append(Anchor(
                        int(a["id"]), np.asarray(a["p_AinG"], float) - origin, float(a.get("const_bias", 0.0)),
                        float(a.get("dist_bias", 0.0)), bool(a.get("fix", False)),
                        np.array([float(a.get("prior_p_AinG_cov", 0.05))] * 3
                                 + [float(a.get("prior_const_bias_cov", 0.2)),
                                    float(a.get("prior_dist_bias_cov", 0.02))])))
        cfg = dataclasses.replace(
            cfg, anchors=anchors, sigma_range=float(tag.get("uwb_sigma_range", 0.1)),
            uwb_chi2_mult=float(tag.get("uwb_chi2_multipler", 1.0)),
            min_dist_to_use_uwb=float(init.get("min_dist_to_use_uwb", 0.0)),
            calib_uwb_extrinsics=bool(tag.get("calib_uwb_extrinsics", False)),
            p_IinU=-np.asarray(tag.get("p_UinI", [0.0, 0.0, 0.0]), float),
            p_IinU_prior_var=float(tag.get("prior_uwb_imu_cov", 0.1)))
    return cfg

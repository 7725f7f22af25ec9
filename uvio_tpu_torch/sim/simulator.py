"""Deterministic VIO simulator: the port's input source.

Port of the image-pipeline part of `uvio_tpu/sim/simulator.py` (the
reference's `ov_msckf/src/sim/Simulator`): a cubic SE(3) B-spline
trajectory, a persistent 3D feature map, seeded IMU noise (white noise
+ random-walk biases) and rendered grayscale frames. It stands where a
camera, an IMU and a UWB radio would and is not part of the measured step,
so it runs on the host CPU in float64. Its numpy RNG streams are
`uvio_tpu`'s (one generator for the IMU, one per camera, one for UWB, one
for the map), seeded and consumed in the same order, so the same seed
gives the same sensor data.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..cam import RADTAN, distort
from ..math import quat_to_rot, rot_to_quat
from . import bspline

_F64 = torch.float64


@dataclasses.dataclass
class SimCamera:
    model: int = RADTAN
    intrinsics: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([458.0, 458.0, 367.0, 248.0, 0.0, 0.0, 0.0, 0.0])
    )
    q_ItoC: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    p_IinC: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    width: int = 752
    height: int = 480


@dataclasses.dataclass
class SimParams:
    sim_freq_imu: float = 400.0
    sim_freq_cam: float = 10.0
    sigma_w: float = 1.6968e-04
    sigma_wb: float = 1.9393e-05
    sigma_a: float = 2.0000e-3
    sigma_ab: float = 3.0000e-03
    sigma_pix: float = 1.0
    gravity_mag: float = 9.81
    num_pts: int = 50
    min_feature_depth: float = 5.0
    max_feature_depth: float = 10.0
    map_density_hz: float = 2.0  # map spawn rate along trajectory
    pts_per_spawn: int = 50
    seed: int = 10
    cameras: List[SimCamera] = dataclasses.field(default_factory=lambda: [SimCamera()])
    # UWB simulation (empty = disabled). anchors: id -> (p_AinG, gamma, alpha)
    uwb_anchors: dict = dataclasses.field(default_factory=dict)
    uwb_freq: float = 20.0
    sigma_range: float = 0.1
    uwb_p_IinU: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # true IMU intrinsics (None = perfect IMU), see `uvio_tpu.sim.SimParams`
    imu_model: int = 0  # 0 = kalibr, 1 = rpng (Dm triangle fill)
    imu_dw: Optional[np.ndarray] = None  # (6,)
    imu_da: Optional[np.ndarray] = None  # (6,)
    imu_tg: Optional[np.ndarray] = None  # (9,)
    imu_gq: Optional[np.ndarray] = None  # (4,) q_GYROtoIMU
    imu_aq: Optional[np.ndarray] = None  # (4,) q_ACCtoIMU


def _rot_np(q) -> np.ndarray:
    return quat_to_rot(torch.as_tensor(np.asarray(q, float), dtype=_F64)).numpy()


def circle_trajectory(
    duration: float = 60.0,
    radius: float = 2.0,
    height_amp: float = 0.6,
    hz: float = 20.0,
    still_time: float = 0.0,
    lap_s: float = 20.0,
    rate_mod: float = 0.0,
):
    """Procedural smooth trajectory: a circle with vertical bobbing and
    tangent-facing yaw, with full 6-dof excitation (`uvio_tpu`
    `circle_trajectory`). Returns (t, q_GtoI, p_IinG) as numpy."""
    from scipy.spatial.transform import Rotation as Rsp

    t = np.arange(0.0, duration, 1.0 / hz)
    if still_time > 0.0:
        phase = np.clip(t - still_time, 0.0, None)
        ramp = np.where(phase < 2.0, phase**2 / 4.0, phase - 1.0)
    else:
        ramp = t
    if rate_mod > 0.0:
        ramp = ramp + rate_mod * lap_s / (2.0 * np.pi) * np.sin(2.0 * np.pi * ramp / 5.0)
    th = 2.0 * np.pi * ramp / lap_s
    p = np.stack(
        [radius * np.cos(th), radius * np.sin(th), height_amp * np.sin(2.2 * th)], axis=1
    )
    yaw = th + np.pi / 2.0
    roll = 0.2 * np.sin(1.7 * th)
    pitch = 0.15 * np.cos(2.3 * th)
    R_ItoG = Rsp.from_euler("zyx", np.stack([yaw, pitch, roll], axis=1)).as_matrix()
    q_GtoI = rot_to_quat(torch.as_tensor(np.transpose(R_ItoG, (0, 2, 1)), dtype=_F64)).numpy()
    return t, q_GtoI, p


def load_tum_trajectory(path: str):
    """Load `timestamp tx ty tz qx qy qz qw` (JPL q_GtoI, as the
    reference's `DatasetReader::load_simulated_trajectory`)."""
    data = np.loadtxt(path, comments="#")
    t = data[:, 0]
    p = data[:, 1:4]
    q = data[:, 4:8]
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return t, q, p


def _project_map(pts_G, R_GtoI, p_IinG, R_ItoC, p_IinC, intrinsics, width, height, min_d, max_d):
    """Project all map points into one camera; returns (uv (N,2), mask)."""
    p_FinI = (pts_G - p_IinG[None, :]) @ R_GtoI.T
    p_FinC = p_FinI @ R_ItoC.T + p_IinC[None, :]
    z = p_FinC[:, 2]
    uv_norm = p_FinC[:, :2] / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)[:, None]
    uv = distort(intrinsics, RADTAN, uv_norm)
    ok = (
        (z > min_d) & (z < max_d)
        & (uv[:, 0] > 0) & (uv[:, 0] < width - 1)
        & (uv[:, 1] > 0) & (uv[:, 1] < height - 1)
    )
    return uv, ok


class Simulator:
    """Seeded sensor stream generator over a spline trajectory."""

    def __init__(self, params: SimParams, trajectory=None):
        self.params = params
        if trajectory is None:
            trajectory = circle_trajectory()
        times, q_GtoI, p_IinG = trajectory
        self.t0_traj, self.dt_ctrl, self.controls = bspline.build_controls(times, q_GtoI, p_IinG)
        # usable spline time range (needs one control each side)
        self.t_start = self.t0_traj + 2.0 * self.dt_ctrl
        self.t_end = float(times[-1]) - 2.0 * self.dt_ctrl

        self.rng_imu = np.random.default_rng(params.seed)
        self.rng_cams = [
            np.random.default_rng(params.seed + 1 + i) for i in range(len(params.cameras))
        ]
        self.rng_map = np.random.default_rng(params.seed + 100)
        self.rng_uwb = np.random.default_rng(params.seed + 50)
        self.cur_imu_t = self.t_start
        self.cur_cam_t = self.t_start
        self.cur_uwb_t = self.t_start
        self.true_bg = np.zeros(3)
        self.true_ba = np.zeros(3)

        def _dm(vec):
            if vec is None:
                return np.eye(3)
            v = np.asarray(vec, float)
            if params.imu_model == 0:  # kalibr: lower triangular
                return np.array([[v[0], 0, 0], [v[1], v[3], 0], [v[2], v[4], v[5]]])
            return np.array([[v[0], v[1], v[3]], [0, v[2], v[4]], [0, 0, v[5]]])

        self._Dw_inv = np.linalg.inv(_dm(params.imu_dw))
        self._Da_inv = np.linalg.inv(_dm(params.imu_da))
        self._Tg = (
            np.asarray(params.imu_tg, float).reshape(3, 3).T
            if params.imu_tg is not None
            else np.zeros((3, 3))
        )
        self._R_w_T = (np.eye(3) if params.imu_gq is None else _rot_np(params.imu_gq)).T
        self._R_a_T = (np.eye(3) if params.imu_aq is None else _rot_np(params.imu_aq)).T
        # bias history for groundtruth lookup (timestamp -> bias)
        self.bias_hist: List[Tuple[float, np.ndarray, np.ndarray]] = [
            (self.cur_imu_t, self.true_bg.copy(), self.true_ba.copy())
        ]
        self._gen_feature_map()

    def _state(self, t):
        return bspline.state_at(self.controls, self.t0_traj, self.dt_ctrl, torch.as_tensor(t, dtype=_F64))

    # -- map -----------------------------------------------------------
    def _gen_feature_map(self):
        """Spawn frustum points at regular trajectory samples."""
        p = self.params
        ts = np.arange(self.t_start, self.t_end, 1.0 / p.map_density_hz)
        states = self._state(ts)
        pts = []
        for i in range(len(ts)):
            R_GtoI = states["R_GtoI"][i].numpy()
            p_IinG = states["p_IinG"][i].numpy()
            for cam in p.cameras:
                R_ItoC = _rot_np(cam.q_ItoC)
                fx, fy, cx, cy = cam.intrinsics[:4]
                n = p.pts_per_spawn // max(1, len(p.cameras))
                u = self.rng_map.uniform(0, cam.width, n)
                v = self.rng_map.uniform(0, cam.height, n)
                d = self.rng_map.uniform(p.min_feature_depth, p.max_feature_depth, n)
                p_FinC = np.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], axis=1)
                p_FinI = (p_FinC - cam.p_IinC[None, :]) @ R_ItoC
                pts.append(p_FinI @ R_GtoI + p_IinG[None, :])
        self.map_pts = np.concatenate(pts, axis=0)

    # -- groundtruth ---------------------------------------------------
    def get_gt_state(self, t: float):
        """q_GtoI, p, v, bg, ba at time t (exact spline + bias history)."""
        st = self._state([t])
        bt = np.array([b[0] for b in self.bias_hist])
        i = np.clip(np.searchsorted(bt, t) - 1, 0, len(self.bias_hist) - 1)
        return {
            "q_GtoI": rot_to_quat(st["R_GtoI"][0]).numpy(),
            "p_IinG": st["p_IinG"][0].numpy(),
            "v_IinG": st["v_IinG"][0].numpy(),
            "bg": self.bias_hist[i][1],
            "ba": self.bias_hist[i][2],
        }

    def ok(self):
        return self.cur_imu_t < self.t_end and self.cur_cam_t < self.t_end

    # -- sensors -------------------------------------------------------
    def get_next_imu(self) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        p = self.params
        dt = 1.0 / p.sim_freq_imu
        t = self.cur_imu_t + dt
        if t > self.t_end:
            return None
        self.cur_imu_t = t
        st = self._state([t])
        R_GtoI = st["R_GtoI"][0].numpy()
        a_IinG = st["a_IinG"][0].numpy()
        w_IinI = st["w_IinI"][0].numpy()
        accel_inI = R_GtoI @ (a_IinG + np.array([0.0, 0.0, p.gravity_mag]))
        # bias random walk then white noise (Simulator.cpp:360-385)
        self.true_bg = self.true_bg + p.sigma_wb * np.sqrt(dt) * self.rng_imu.standard_normal(3)
        self.true_ba = self.true_ba + p.sigma_ab * np.sqrt(dt) * self.rng_imu.standard_normal(3)
        self.bias_hist.append((t, self.true_bg.copy(), self.true_ba.copy()))
        wm = (
            self._Dw_inv @ (self._R_w_T @ w_IinI)
            + self.true_bg
            + self._Tg @ accel_inI
            + p.sigma_w / np.sqrt(dt) * self.rng_imu.standard_normal(3)
        )
        am = (
            self._Da_inv @ (self._R_a_T @ accel_inI)
            + self.true_ba
            + p.sigma_a / np.sqrt(dt) * self.rng_imu.standard_normal(3)
        )
        return t, wm, am

    def _project(self, st, cam):
        """All map points in `cam` at spline state `st`: (uv (N,2), ok (N,))
        as numpy."""
        uv, ok = _project_map(
            torch.as_tensor(self.map_pts, dtype=_F64), st["R_GtoI"][0], st["p_IinG"][0],
            quat_to_rot(torch.as_tensor(cam.q_ItoC, dtype=_F64)),
            torch.as_tensor(cam.p_IinC, dtype=_F64), torch.as_tensor(cam.intrinsics, dtype=_F64),
            float(cam.width), float(cam.height), 0.1, 80.0,
        )
        return uv.numpy(), ok.numpy()

    def get_next_uwb(self):
        """Noisy biased ranges to all configured anchors, (t, {id: range})
        or None: y = (1+alpha) d + gamma + n  (uvio range model)."""
        p = self.params
        if not p.uwb_anchors:
            return None
        t = self.cur_uwb_t + 1.0 / p.uwb_freq
        if t > self.t_end:
            return None
        self.cur_uwb_t = t
        st = self._state([t])
        p_UinG = st["p_IinG"][0].numpy() - st["R_GtoI"][0].numpy().T @ p.uwb_p_IinU
        ranges = {}
        for aid, (p_A, gamma, alpha) in p.uwb_anchors.items():
            d = np.linalg.norm(np.asarray(p_A) - p_UinG)
            ranges[aid] = (1 + alpha) * d + gamma + p.sigma_range * self.rng_uwb.standard_normal()
        return t, ranges

    def get_next_cam(self):
        """Returns (t, [(ids, uvs) per camera]) or None.

        uv noise sigma_pix; ids are persistent map indices (TrackSIM
        semantics, `ov_core/src/track/TrackSIM.h:37-70`)."""
        p = self.params
        t = self.cur_cam_t + 1.0 / p.sim_freq_cam
        if t > self.t_end:
            return None
        self.cur_cam_t = t
        st = self._state([t])
        out = []
        for ci, cam in enumerate(p.cameras):
            uv, ok = self._project(st, cam)
            ids = np.nonzero(ok)[0][: p.num_pts]
            uvs = uv[ids]
            out.append((ids, uvs + p.sigma_pix * self.rng_cams[ci].standard_normal(uvs.shape)))
        return t, out

    def render_image(self, t: float, cam_idx: int = 0, blob_sigma: float = 1.2):
        """Synthetic grayscale frame: map points as Gaussian blobs with a
        per-point deterministic appearance over a smooth background."""
        cam = self.params.cameras[cam_idx]
        uv, okn = self._project(self._state([t]), cam)
        uv = uv[okn]
        pt_ids = np.nonzero(okn)[0]
        H, W = cam.height, cam.width
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        img = 40.0 + 20.0 * (xx / W) + 10.0 * (yy / H)
        for pid, (u, v) in zip(pt_ids, uv):
            h1 = (pid * 2654435761) % 97 / 97.0
            h2 = (pid * 40503) % 89 / 89.0
            amp = 120.0 + 120.0 * h1
            sx = blob_sigma * (0.8 + 0.9 * h2)
            sy = blob_sigma * (0.8 + 0.9 * ((h1 + h2) % 1.0))
            x0, x1 = max(0, int(u) - 5), min(W, int(u) + 6)
            y0, y1 = max(0, int(v) - 5), min(H, int(v) + 6)
            if x1 <= x0 or y1 <= y0:
                continue
            gx = np.exp(-((np.arange(x0, x1) - u) ** 2) / (2 * sx**2))
            gy = np.exp(-((np.arange(y0, y1) - v) ** 2) / (2 * sy**2))
            img[y0:y1, x0:x1] += amp * gy[:, None] * gx[None, :]
        return np.clip(img, 0, 255).astype(np.float32)

    def render_image_hard(
        self,
        t: float,
        cam_idx: int = 0,
        blob_sigma: float = 1.2,
        motion_blur: float = 0.012,
        exposure: bool = True,
        occlusion: bool = True,
    ):
        """Adversarial rendered frame for frontend robustness testing
        (the stand-in for a real-image dataset regression):

        - rotation-consistent far background texture (sampled from a
          procedural function of the per-pixel viewing DIRECTION, so it
          moves correctly under rotation and has no translation
          parallax: distant clutter that tempts the detector),
        - motion blur: average of renders at t and t +/- motion_blur,
        - exposure ramp: global gain/bias cycling over time (defeats
          trackers without histogram equalization, `TrackKLT.cpp:56-67`),
        - occlusion: a moving dark foreground rectangle with its own
          bright pseudo-corners (features on it violate epipolar
          geometry and must die by RANSAC/track loss).
        """
        cam = self.params.cameras[cam_idx]
        H, W = cam.height, cam.width
        fx, fy, cx, cy = np.asarray(cam.intrinsics[:4])
        R_ItoC = _rot_np(cam.q_ItoC)

        def one(tt):
            img = self.render_image(tt, cam_idx, blob_sigma)
            R_GtoC = R_ItoC @ self._state([tt])["R_GtoI"][0].numpy()
            # viewing directions in the GLOBAL frame (pinhole approx:
            # the background is texture, not geometry)
            uu, vv = np.meshgrid((np.arange(W) - cx) / fx, (np.arange(H) - cy) / fy)
            d = np.stack([uu, vv, np.ones_like(uu)], axis=-1) @ R_GtoC  # rows: d^T R = (R^T d)^T
            n = d / np.linalg.norm(d, axis=-1, keepdims=True)
            tex = (
                18.0 * np.sin(9.0 * n[..., 0] + 5.0 * n[..., 2])
                + 14.0 * np.sin(11.0 * n[..., 1] - 3.0 * n[..., 0])
                + 10.0 * np.sin(7.0 * (n[..., 0] + n[..., 1] + 1.3 * n[..., 2]))
            )
            return img + tex

        if motion_blur > 0:
            img = (one(t - motion_blur) + one(t) + one(t + motion_blur)) / 3.0
        else:
            img = one(t)

        if occlusion:
            # foreground occluder sweeping horizontally, ~1/5 of the image
            xc = int(W * (0.5 + 0.38 * np.sin(0.7 * (t - self.t_start))))
            x0, x1 = max(0, xc - W // 10), min(W, xc + W // 10)
            y0, y1 = H // 4, H - H // 4
            img[y0:y1, x0:x1] = 25.0
            # pseudo-corners on the occluder (move with IT, not the world)
            rng = np.random.default_rng(99)
            for ry, rx in rng.uniform(0.1, 0.9, (6, 2)):
                oy = int(y0 + ry * (y1 - y0))
                ox = int(x0 + rx * (x1 - x0))
                img[max(0, oy - 1) : oy + 2, max(0, ox - 1) : ox + 2] = 230.0

        if exposure:
            g = 1.0 + 0.45 * np.sin(0.9 * (t - self.t_start))
            img = img * g + 12.0 * np.sin(1.3 * (t - self.t_start))

        return np.clip(img, 0, 255).astype(np.float32)


def perturb_calibration(cfg, seed: int = 0):
    """Return a copy of a VioConfig with its calibration states perturbed
    by the reference's std-devs (`Simulator::perturb_parameters`,
    `Simulator.cpp:209-266`): dt 0.01 s; cam focal/center 1.0 px,
    distortion 0.005; cam extrinsic rotation 0.001 rad / position
    0.01 m; IMU Dw/Da 0.004, frame rotation 0.002 rad, Tg 0.004. IMU
    blocks only when the matching calib toggle is on, exactly like the
    reference. The numpy generator is drawn from in `uvio_tpu`'s order,
    so the same seed gives the same perturbation.

    Use for calibration-error experiments: run the simulator with true
    parameters and the estimator with `perturb_calibration(cfg)`.
    """
    from ..math import exp_so3, quat_multiply
    from ..types.state import dm_identity

    rng = np.random.default_rng(seed)

    def rotate_quat(q, std):
        dq = rot_to_quat(exp_so3(torch.as_tensor(std * rng.standard_normal(3), dtype=_F64)))
        return quat_multiply(dq, torch.as_tensor(np.asarray(q, float), dtype=_F64)).numpy()

    new_cams = []
    dt = float(getattr(cfg, "camimu_dt", 0.0)) + 0.01 * rng.standard_normal()
    for cam in cfg.cameras:
        intr = np.asarray(cam.intrinsics, float).copy()
        intr[:4] += 1.0 * rng.standard_normal(4)
        intr[4:8] += 0.005 * rng.standard_normal(4)
        q = rotate_quat(cam.q_ItoC, 0.001)
        p = np.asarray(cam.p_IinC, float) + 0.01 * rng.standard_normal(3)
        new_cams.append(dataclasses.replace(cam, intrinsics=intr, q_ItoC=q, p_IinC=p))

    out = dataclasses.replace(cfg, cameras=new_cams, camimu_dt=dt)
    if getattr(cfg, "calib_imu_intrinsics", False):
        dw = np.asarray(cfg.imu_dw if cfg.imu_dw is not None else dm_identity(cfg.imu_model), float)
        da = np.asarray(cfg.imu_da if cfg.imu_da is not None else dm_identity(cfg.imu_model), float)
        out = dataclasses.replace(
            out,
            imu_dw=dw + 0.004 * rng.standard_normal(6),
            imu_da=da + 0.004 * rng.standard_normal(6),
        )
        q0 = np.array([0.0, 0.0, 0.0, 1.0])
        if cfg.imu_model == 0:  # kalibr: gyro frame
            gq = cfg.imu_gq if cfg.imu_gq is not None else q0
            out = dataclasses.replace(out, imu_gq=rotate_quat(gq, 0.002))
        else:  # rpng: acc frame
            aq = cfg.imu_aq if cfg.imu_aq is not None else q0
            out = dataclasses.replace(out, imu_aq=rotate_quat(aq, 0.002))
    if getattr(cfg, "calib_imu_g_sensitivity", False):
        tg = np.asarray(cfg.imu_tg if cfg.imu_tg is not None else np.zeros(9), float)
        out = dataclasses.replace(out, imu_tg=tg + 0.004 * rng.standard_normal(9))
    return out

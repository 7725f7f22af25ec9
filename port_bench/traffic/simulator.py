"""The seeded sensor simulator, vectorised: a whole stream in one pass.

A frozen copy of the port's `sim/simulator.py` (`Simulator`, itself
`uvio_tpu`'s and, further back, OpenVINS's `ov_msckf/src/sim/Simulator`),
rewritten to make every sample of a stream at once: the spline is
evaluated at all IMU, camera and range times in a few batched calls, and
each numpy generator draws its whole share in one call. The generators
are seeded and drawn in the copy's order (one for the IMU, one per
camera, one for the map, one for UWB), so for the same seed, trajectory
and start the samples equal those of `Simulator.get_next_imu`,
`get_next_cam` and `get_next_uwb` called in a loop; the tests hold the
two together.

Two things the port's simulator cannot do are added, both off by
default: the stream may start later on the trajectory than its first
usable time (`t_begin`), and the range sets may run at an offset to the
IMU clock (`uwb_t_offset`), as the C++ simulator's do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import bspline
from .lie import RADTAN, distort, quat_to_rot, rot_to_quat

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
    map_density_hz: float = 2.0
    pts_per_spawn: int = 50
    seed: int = 10
    cameras: List[SimCamera] = dataclasses.field(default_factory=lambda: [SimCamera()])
    # anchors: id -> (p_AinG, gamma, alpha); empty = no UWB
    uwb_anchors: dict = dataclasses.field(default_factory=dict)
    uwb_freq: float = 20.0
    sigma_range: float = 0.1
    uwb_p_IinU: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    uwb_t_offset: float = 0.0


def _rot(q) -> torch.Tensor:
    return quat_to_rot(torch.as_tensor(np.asarray(q, float), dtype=_F64))


def _accumulate(t0: float, step: float, t_stop: float) -> np.ndarray:
    """t0 + step, + step, ... up to t_stop, each sum rounded as the
    simulator's running `cur_t += step` rounds it."""
    n = int((t_stop - t0) / step) + 2
    t = np.add.accumulate(np.concatenate([[t0], np.full(n, step)]))[1:]
    return t[t <= t_stop]


@dataclasses.dataclass
class Stream:
    """One stream, as the sensors deliver it.

    `events` lists ("imu", i), ("uwb", j) and ("cam", k) in the order a
    live loop feeds them: each IMU sample, then a range set and a frame
    whose time has come by that sample (the simulator's own loop)."""

    t_begin: float
    imu_t: np.ndarray
    imu_w: np.ndarray
    imu_a: np.ndarray
    cam_t: np.ndarray
    tracks: List[List[Tuple[np.ndarray, np.ndarray]]]  # per frame, per camera (ids, uvs)
    uwb_t: np.ndarray
    uwb_ranges: np.ndarray  # (U, A), anchor order of `uwb_ids`
    uwb_ids: List[int]
    events: List[Tuple[str, int]]
    true_bg: np.ndarray  # (N+1, 3): at t_begin, then after each IMU sample
    true_ba: np.ndarray


class Simulator:
    """The port's `Simulator` over a trajectory, with the whole stream
    made by `stream()`."""

    def __init__(self, params: SimParams, trajectory, t_begin: Optional[float] = None,
                 map_span: Optional[Tuple[float, float]] = None):
        self.params = params
        times, q_GtoI, p_IinG = trajectory
        self.t0_traj, self.dt_ctrl, self.controls = bspline.build_controls(times, q_GtoI, p_IinG)
        self.t_start = self.t0_traj + 2.0 * self.dt_ctrl
        self.t_end = float(times[-1]) - 2.0 * self.dt_ctrl
        self.t_begin = self.t_start if t_begin is None else float(t_begin)
        if not self.t_start <= self.t_begin < self.t_end:
            raise ValueError(f"stream start {self.t_begin} outside [{self.t_start}, {self.t_end})")
        s = params.seed
        self.rng_imu = np.random.default_rng(s)
        self.rng_cams = [np.random.default_rng(s + 1 + i) for i in range(len(params.cameras))]
        self.rng_map = np.random.default_rng(s + 100)
        self.rng_uwb = np.random.default_rng(s + 50)
        self._gen_feature_map(*(map_span or (self.t_start, self.t_end)))

    def state(self, t):
        return bspline.state_at(self.controls, self.t0_traj, self.dt_ctrl, torch.as_tensor(t, dtype=_F64))

    def _gen_feature_map(self, t0: float, t1: float):
        """Frustum points spawned at regular trajectory samples in
        [t0, t1): for each sample and camera, depths and pixels drawn from
        the map generator in the copy's order (u, v, depth)."""
        p = self.params
        ts = np.arange(t0, t1, 1.0 / p.map_density_hz)
        st = self.state(ts)
        R_GtoI, p_IinG = st["R_GtoI"], st["p_IinG"]
        per_cam = []
        n = p.pts_per_spawn // max(1, len(p.cameras))
        draws = self.rng_map.random((len(ts), len(p.cameras), 3, n))
        for ci, cam in enumerate(p.cameras):
            fx, fy, cx, cy = cam.intrinsics[:4]
            u = cam.width * draws[:, ci, 0]
            v = cam.height * draws[:, ci, 1]
            d = p.min_feature_depth + (p.max_feature_depth - p.min_feature_depth) * draws[:, ci, 2]
            p_FinC = torch.as_tensor(np.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], axis=-1), dtype=_F64)
            p_FinI = (p_FinC - torch.as_tensor(cam.p_IinC, dtype=_F64)) @ _rot(cam.q_ItoC)
            per_cam.append(p_FinI @ R_GtoI + p_IinG[:, None, :])  # (S, n, 3)
        # the copy appends spawn by spawn, camera by camera
        self.map_pts = torch.stack(per_cam, dim=1).reshape(-1, 3)

    def project(self, R_GtoI, p_IinG, cam: SimCamera, min_d=0.1, max_d=80.0):
        """Every map point in `cam` at one pose: (uv (N,2), ok (N,))."""
        p_FinI = (self.map_pts - p_IinG[None, :]) @ R_GtoI.T
        p_FinC = p_FinI @ _rot(cam.q_ItoC).T + torch.as_tensor(cam.p_IinC, dtype=_F64)[None, :]
        z = p_FinC[:, 2]
        uv_norm = p_FinC[:, :2] / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)[:, None]
        uv = distort(torch.as_tensor(cam.intrinsics, dtype=_F64), uv_norm)
        ok = ((z > min_d) & (z < max_d) & (uv[:, 0] > 0) & (uv[:, 0] < cam.width - 1)
              & (uv[:, 1] > 0) & (uv[:, 1] < cam.height - 1))
        return uv, ok

    def stream(self, t_stop: float, tracks: bool = True) -> Stream:
        """Every sample from `t_begin` to `t_stop` (sensor clock)."""
        p = self.params
        t_stop = min(t_stop, self.t_end)
        dt = 1.0 / p.sim_freq_imu
        imu_t = _accumulate(self.t_begin, dt, t_stop)
        N = len(imu_t)
        st = self.state(imu_t)
        R_GtoI = st["R_GtoI"]
        accel = (R_GtoI @ (st["a_IinG"] + torch.tensor([0.0, 0.0, p.gravity_mag], dtype=_F64))[..., None])[..., 0]
        z = self.rng_imu.standard_normal((N, 4, 3))
        bg = np.add.accumulate(np.concatenate([np.zeros((1, 3)), p.sigma_wb * np.sqrt(dt) * z[:, 0]]))
        ba = np.add.accumulate(np.concatenate([np.zeros((1, 3)), p.sigma_ab * np.sqrt(dt) * z[:, 1]]))
        imu_w = st["w_IinI"].numpy() + bg[1:] + p.sigma_w / np.sqrt(dt) * z[:, 2]
        imu_a = accel.numpy() + ba[1:] + p.sigma_a / np.sqrt(dt) * z[:, 3]

        # frames and range sets are due at the first IMU sample at or
        # after their time (the simulator's loop)
        cam_t = _accumulate(self.t_begin, 1.0 / p.sim_freq_cam, imu_t[-1])
        uwb_t = (_accumulate(self.t_begin + p.uwb_t_offset, 1.0 / p.uwb_freq, imu_t[-1])
                 if p.uwb_anchors else np.zeros(0))
        frames = []
        if tracks and len(cam_t):
            sc = self.state(cam_t)
            per_cam = []
            for ci, cam in enumerate(p.cameras):
                ids_uv = []
                for k in range(len(cam_t)):
                    uv, ok = self.project(sc["R_GtoI"][k], sc["p_IinG"][k], cam)
                    ids = torch.nonzero(ok)[:, 0][: p.num_pts]
                    ids_uv.append((ids.numpy(), uv[ids].numpy()))
                noise = self.rng_cams[ci].standard_normal((sum(len(i) for i, _ in ids_uv), 2))
                out, o = [], 0
                for ids, uv in ids_uv:
                    out.append((ids, uv + p.sigma_pix * noise[o:o + len(ids)]))
                    o += len(ids)
                per_cam.append(out)
            frames = [[per_cam[ci][k] for ci in range(len(p.cameras))] for k in range(len(cam_t))]

        uwb_ids = list(p.uwb_anchors)
        ranges = np.zeros((len(uwb_t), len(uwb_ids)))
        if len(uwb_t):
            su = self.state(uwb_t)
            p_UinG = (su["p_IinG"] - (su["R_GtoI"].transpose(-1, -2)
                                      @ torch.as_tensor(p.uwb_p_IinU, dtype=_F64))).numpy()
            noise = self.rng_uwb.standard_normal((len(uwb_t), len(uwb_ids)))
            for j, aid in enumerate(uwb_ids):
                p_A, gamma, alpha = p.uwb_anchors[aid]
                d = np.linalg.norm(np.asarray(p_A)[None, :] - p_UinG, axis=1)
                ranges[:, j] = (1 + alpha) * d + gamma + p.sigma_range * noise[:, j]

        events = []
        ci = ui = 0
        for i, t in enumerate(imu_t):
            events.append(("imu", i))
            if ui < len(uwb_t) and uwb_t[ui] <= t:
                events.append(("uwb", ui))
                ui += 1
            if ci < len(cam_t) and cam_t[ci] <= t:
                events.append(("cam", ci))
                ci += 1
        return Stream(self.t_begin, imu_t, imu_w, imu_a, cam_t[:ci], frames[:ci], uwb_t[:ui], ranges[:ui],
                      uwb_ids, events, bg, ba)

    def gt_state(self, t: float, stream: Stream) -> Dict[str, np.ndarray]:
        """q_GtoI, p, v at `t` from the spline, and the true biases of the
        last IMU sample before `t` (the copy's `get_gt_state`)."""
        st = self.state([t])
        bt = np.concatenate([[stream.t_begin], stream.imu_t])
        i = int(np.clip(np.searchsorted(bt, t) - 1, 0, len(bt) - 1))
        return {"q_GtoI": rot_to_quat(st["R_GtoI"][0]).numpy(), "p_IinG": st["p_IinG"][0].numpy(),
                "v_IinG": st["v_IinG"][0].numpy(), "bg": stream.true_bg[i], "ba": stream.true_ba[i]}

"""The general traffic generator: a configuration and a mix, a seed, a
window length -> every input of one run.

A configuration (`configs/<name>.json`) fixes the deployment: the
trajectory and where on it the stream starts, the sensors' rates, the
map, the anchors' true positions and biases, and the estimator's own
settings (`configs/<name>/`, the YAML files the estimator reads; its
camera, IMU noise, pixel and range noise and UWB lever arm are what the
simulated sensors use too, as in the C++ simulator). A mix
(`mixes/<name>.json`) fixes how the stream is fed:

  * `warmup_s`: sensor seconds fed as fast as they go before the window;
  * `range_drop_prob`: each range dropped on its own with this
    probability;
  * `outage_period_s`, `outage_s`: in every period of the trajectory a
    stretch this long with no anchor in range (0 for none).

The seed draws the sensor noise, the map and the drops;
the trajectory, the start and the rates do not change with it, so every
seed feeds the same number of samples and frames.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..reference import config as estimator_config
from .lie import rot_to_quat
from .simulator import RADTAN, SimCamera, SimParams, Simulator, Stream


@dataclasses.dataclass
class Traffic:
    stream: Stream
    sim: Simulator
    n_warmup: int  # frames fed as fast as they go
    n_window: int  # frames due in the window
    gt0: dict  # the true state at the stream's start
    uwb_mask: np.ndarray  # (U, A) which ranges are delivered

    def ranges(self, j: int) -> dict:
        """Range set j as the radio delivers it: {anchor id: range}."""
        s = self.stream
        return {aid: float(s.uwb_ranges[j, a]) for a, aid in enumerate(s.uwb_ids) if self.uwb_mask[j, a]}


def load_trajectory(path: str):
    """`t x y z qx qy qz qw` rows (JPL q_GtoI) as (t, q, p)."""
    data = np.loadtxt(path, comments="#")
    q = data[:, 4:8] / np.linalg.norm(data[:, 4:8], axis=1, keepdims=True)
    return data[:, 0], q, data[:, 1:4]


def sim_params(config: dict, est, seed: int) -> SimParams:
    s = config["sim"]
    cams = [SimCamera(model=RADTAN, intrinsics=c.intrinsics,
                      q_ItoC=rot_to_quat(torch.as_tensor(c.R_ItoC, dtype=torch.float64)).numpy(),
                      p_IinC=c.p_IinC) for c in est.cameras]
    anchors = {int(k): (np.asarray(v[:3], float), float(v[3]), float(v[4]))
               for k, v in s.get("anchors", {}).items()}
    return SimParams(
        sim_freq_imu=s["imu_hz"], sim_freq_cam=s["cam_hz"],
        sigma_w=est.sigma_w, sigma_wb=est.sigma_wb, sigma_a=est.sigma_a, sigma_ab=est.sigma_ab,
        sigma_pix=est.sigma_pix, gravity_mag=est.gravity_mag, num_pts=s["num_pts"],
        min_feature_depth=s["min_feature_depth"], max_feature_depth=s["max_feature_depth"],
        map_density_hz=s["map_density_hz"], pts_per_spawn=s["pts_per_spawn"], seed=seed, cameras=cams,
        uwb_anchors=anchors, uwb_freq=s.get("uwb_hz", 20.0), sigma_range=est.sigma_range,
        uwb_p_IinU=est.p_IinU,
        uwb_t_offset=s.get("uwb_t_offset_s", 0.0),
    )


def range_mask(uwb_t: np.ndarray, n_anchors: int, mix: dict, t0: float, seed: int) -> np.ndarray:
    """(U, A) bool: the ranges the radio delivers under `mix`, drawn from
    a generator of its own so the ranges themselves do not change."""
    rng = np.random.default_rng([seed, 7])
    keep = rng.random((len(uwb_t), n_anchors)) >= mix.get("range_drop_prob", 0.0)
    period, out = mix.get("outage_period_s", 0.0), mix.get("outage_s", 0.0)
    if period > 0 and out > 0:
        keep &= (np.mod(uwb_t - t0, period) < period - out)[:, None]
    return keep


def make_traffic(config: dict, mix: dict, seed: int, seconds: float, root: str,
                 frames: Optional[int] = None) -> Traffic:
    """Every input of a run: the stream for the warm-up and a window of
    `seconds` (or of `frames` frames)."""
    est = estimator_config.load(os.path.join(root, "configs", config["estimator"]))
    params = sim_params(config, est, seed)
    traj = load_trajectory(os.path.join(root, "configs", config["trajectory"]))
    t_begin = float(traj[0][0]) + config["start_s"]
    hz = params.sim_freq_cam
    n_warmup = int(round(mix["warmup_s"] * hz))
    n_window = int(round(seconds * hz)) if frames is None else frames
    n = n_warmup + n_window
    # one frame past the window, so its last frame's IMU samples exist
    t_stop = t_begin + (n + 1.5) / hz
    sim = Simulator(params, traj, t_begin=t_begin, map_span=(t_begin - 5.0, t_stop + 1.0))
    stream = sim.stream(t_stop)
    if len(stream.cam_t) < n:
        raise ValueError(f"the trajectory holds {len(stream.cam_t)} frames, the run needs {n}")
    gt0 = sim.gt_state(t_begin, stream)
    mask = range_mask(stream.uwb_t, len(stream.uwb_ids), mix, float(traj[0][0]), seed)
    return Traffic(stream, sim, n_warmup, n_window, gt0, mask)

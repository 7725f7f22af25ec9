"""The traffic of system `klt_vio`: a 200 Hz IMU stream and camera frames
rendered from a map on the trajectory, every input of one run from its
seed.

The IMU, the map and the frame times come from `simulator.Simulator`
(the seed draws the IMU noise and the map). Each frame is rendered the
way the port's `sim/simulator.py` `render_image_hard` renders its
stand-in for a real-image regression, vectorised over frames and points
here and written anew (it imports nothing of the port):

  * every visible map point (projected through the camera's radtan
    model) is a Gaussian blob whose amplitude and widths follow from its
    index, over a smooth gradient;
  * a background texture that is a function of each pixel's viewing
    direction in the world, so it moves with rotation and has no
    parallax;
  * motion blur: the mean of renders at t - 12 ms, t and t + 12 ms;
  * an occluder: a dark rectangle a fifth of the image wide and half of
    it high, sweeping horizontally, with six bright 3x3 pseudo-corners
    that move with it and not with the world (features on it break the
    epipolar geometry and must die by RANSAC or track loss);
  * an exposure ramp (gain and offset cycling with time).

Frames are stored as uint8 (the camera's format, truncated after
clipping to [0, 255]), all of them rendered in set-up, on the card when
there is one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import yaml

from ..reference import config as estimator_config
from .generate import load_trajectory, sim_params
from .lie import distort, quat_to_rot
from .simulator import Simulator, Stream

# frames rendered in one batch (three renders each with motion blur)
CHUNK = 16
BLOB_SIGMA = 1.2  # px, a blob's width before its own factor of 0.8-1.7
MOTION_BLUR_S = 0.012
OCCLUDER_LEVEL, OCCLUDER_CORNER_LEVEL = 25.0, 230.0
# the pseudo-corners' places on the occluder, as fractions of its size
OCCLUDER_CORNERS = np.random.default_rng(99).uniform(0.1, 0.9, (6, 2))
# the tracker's RANSAC generator is seeded with the run's seed plus this
TRACKER_SEED_OFFSET = 17


@dataclasses.dataclass
class Traffic:
    stream: Stream  # IMU samples and frame times; `events` kinds "imu" and "cam"
    sim: Simulator
    n_warmup: int  # frames fed as fast as they go
    n_window: int  # frames due in the window
    gt0: dict  # the true state at the stream's start
    images: np.ndarray  # (F, H, W) uint8, one a frame
    tracker_seed: int  # the seed of the tracker's RANSAC generator


def camera_resolution(directory: str) -> tuple:
    """(width, height) of cam0 in the configuration's Kalibr chain."""
    raw = estimator_config._yaml(os.path.join(directory, "estimator_config.yaml"))
    with open(os.path.join(directory, raw.get("relative_config_imucam", "kalibr_imucam_chain.yaml"))) as f:
        chain = yaml.safe_load("\n".join(ln for ln in f.read().splitlines() if not ln.startswith("%YAML")))
    w, h = chain["cam0"]["resolution"]
    return int(w), int(h)


def _blobs(img, r, pid, uv, sigma, H, W):
    """Add each point's Gaussian blob (11x11 pixels around it) into the
    renders `img` (R, H, W): render r, point index pid, pixel uv."""
    h1 = ((pid * 2654435761) % 97).to(img.dtype) / 97.0
    h2 = ((pid * 40503) % 89).to(img.dtype) / 89.0
    amp = 120.0 + 120.0 * h1
    sx = sigma * (0.8 + 0.9 * h2)
    sy = sigma * (0.8 + 0.9 * torch.remainder(h1 + h2, 1.0))
    off = torch.arange(-5, 6, device=img.device)
    u, v = uv[:, 0], uv[:, 1]
    x = torch.floor(u).long()[:, None] + off  # (P, 11)
    y = torch.floor(v).long()[:, None] + off
    gx = torch.exp(-((x.to(img.dtype) - u[:, None].to(img.dtype)) ** 2) / (2 * sx[:, None] ** 2))
    gy = torch.exp(-((y.to(img.dtype) - v[:, None].to(img.dtype)) ** 2) / (2 * sy[:, None] ** 2))
    val = amp[:, None, None] * gy[:, :, None] * gx[:, None, :]
    inside = ((x >= 0) & (x < W))[:, None, :] & ((y >= 0) & (y < H))[:, :, None]
    idx = r[:, None, None] * (H * W) + y.clamp(0, H - 1)[:, :, None] * W + x.clamp(0, W - 1)[:, None, :]
    img.view(-1).index_add_(0, idx[inside], val[inside])


def occlude(img, dt: float):
    """Paint the occluder into one frame `img` (H, W) at `dt` s from the
    stream's start: its centre sweeps as 0.5 + 0.38 sin(0.7 dt) of the
    width."""
    H, W = img.shape
    xc = int(W * (0.5 + 0.38 * np.sin(0.7 * dt)))
    x0, x1 = max(0, xc - W // 10), min(W, xc + W // 10)
    y0, y1 = H // 4, H - H // 4
    img[y0:y1, x0:x1] = OCCLUDER_LEVEL
    for ry, rx in OCCLUDER_CORNERS:
        oy, ox = int(y0 + ry * (y1 - y0)), int(x0 + rx * (x1 - x0))
        img[max(0, oy - 1):oy + 2, max(0, ox - 1):ox + 2] = OCCLUDER_CORNER_LEVEL


def render(sim: Simulator, cam, W: int, H: int, cam_t: np.ndarray, t0: float, device) -> np.ndarray:
    """The frames at `cam_t` (sensor clock) as (F, H, W) uint8."""
    offs = [-MOTION_BLUR_S, 0.0, MOTION_BLUR_S]
    f32, f64 = torch.float32, torch.float64
    intr = torch.as_tensor(cam.intrinsics, dtype=f64, device=device)
    R_ItoC = quat_to_rot(torch.as_tensor(cam.q_ItoC, dtype=f64)).to(device)
    p_IinC = torch.as_tensor(cam.p_IinC, dtype=f64, device=device)
    pts = sim.map_pts.to(device)
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=f64), torch.arange(W, device=device, dtype=f64),
                            indexing="ij")
    rays = torch.stack([(xs - intr[2]) / intr[0], (ys - intr[3]) / intr[1], torch.ones_like(xs)], -1)
    base = (40.0 + 20.0 * xs / W + 10.0 * ys / H).to(f32)
    out = np.empty((len(cam_t), H, W), np.uint8)
    for c0 in range(0, len(cam_t), CHUNK):
        tc = np.asarray(cam_t[c0:c0 + CHUNK], float)
        ts = (tc[:, None] + np.asarray(offs)[None, :]).reshape(-1)
        st = sim.state(ts)
        R_GtoI, p_IinG = st["R_GtoI"].to(device), st["p_IinG"].to(device)
        R = len(ts)
        p_FinC = torch.einsum("ij,rnj->rni", R_ItoC,
                              torch.einsum("rij,rnj->rni", R_GtoI, pts[None] - p_IinG[:, None])) + p_IinC
        z = p_FinC[..., 2]
        uv = distort(intr, p_FinC[..., :2] / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)[..., None])
        ok = (z > 0.1) & (z < 80.0) & (uv[..., 0] > 0) & (uv[..., 0] < W - 1) & (uv[..., 1] > 0) & (uv[..., 1] < H - 1)
        r, pid = torch.nonzero(ok, as_tuple=True)
        img = base.expand(R, H, W).clone()
        _blobs(img, r, pid, uv[r, pid], BLOB_SIGMA, H, W)
        # the background texture, a function of the viewing direction in the world
        d = torch.einsum("hwi,rij->rhwj", rays, torch.einsum("ij,rjk->rik", R_ItoC, R_GtoI))
        n = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        tex = (18.0 * torch.sin(9.0 * n[..., 0] + 5.0 * n[..., 2]) + 14.0 * torch.sin(11.0 * n[..., 1] - 3.0 * n[..., 0])
               + 10.0 * torch.sin(7.0 * (n[..., 0] + n[..., 1] + 1.3 * n[..., 2])))
        img = (img + tex.to(f32)).reshape(len(tc), len(offs), H, W).mean(1)
        for k, t in enumerate(tc):
            dt = float(t) - t0
            occlude(img[k], dt)
            img[k] = img[k] * (1.0 + 0.45 * np.sin(0.9 * dt)) + 12.0 * np.sin(1.3 * dt)  # the exposure ramp
        out[c0:c0 + len(tc)] = img.clamp(0.0, 255.0).to(torch.uint8).cpu().numpy()
    return out


def make_traffic(config: dict, mix: dict, seed: int, seconds: float, root: str,
                 frames: Optional[int] = None) -> Traffic:
    """Every input of a run: the IMU stream and the rendered frames of the
    warm-up and of a window of `seconds` (or of `frames` frames)."""
    directory = os.path.join(root, "configs", config["estimator"])
    est = estimator_config.load(directory)
    params = sim_params(config, est, seed)
    traj = load_trajectory(os.path.join(root, "configs", config["trajectory"]))
    t_begin = float(traj[0][0]) + config["start_s"]
    hz = params.sim_freq_cam
    n_warmup = int(round(mix["warmup_s"] * hz))
    n_window = int(round(seconds * hz)) if frames is None else frames
    n = n_warmup + n_window
    t_stop = t_begin + (n + 1.5) / hz  # one frame past the window
    sim = Simulator(params, traj, t_begin=t_begin, map_span=(t_begin - 5.0, t_stop + 1.0))
    stream = sim.stream(t_stop, tracks=False)
    if len(stream.cam_t) < n:
        raise ValueError(f"the trajectory holds {len(stream.cam_t)} frames, the run needs {n}")
    W, H = camera_resolution(directory)
    images = render(sim, params.cameras[0], W, H, stream.cam_t[:n + 1], t_begin,
                    torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    gt0 = sim.gt_state(t_begin, stream)
    tracker_seed = (int(seed) + TRACKER_SEED_OFFSET) % (1 << 63)
    return Traffic(stream, sim, n_warmup, n_window, gt0, images, tracker_seed)

"""EuRoC-format dataset reader and the dataset entry point.

Port of `uvio_tpu/utils/euroc.py`. `EurocDataset` is a copy (numpy and
csv, the numeric files through the port's native loader); `run_euroc`
runs the port's `KLTTracker` (both hand kernels, `fast9` and
`lk_track`, once per frame) into the port's managers, on the card unless
`device` says otherwise. Replaces the reference's ROS bag/subscriber ingestion with a plain
ASL-folder reader (`mav0/imu0/data.csv`, `mav0/cam0/data.csv` +
`data/<stamp>.png`, `mav0/state_groundtruth_estimate0/data.csv`) —
the standard EuRoC MAV / TUM-VI disk layout. Groundtruth loading also
accepts the reference's `ov_data` TUM text files
(`DatasetReader::load_gt_file` equivalent).
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, Optional, Tuple

import numpy as np


class EurocDataset:
    def __init__(self, root: str, cams=("cam0",), imu="imu0"):
        self.root = root
        mav = os.path.join(root, "mav0")
        if os.path.isdir(mav):
            self.base = mav
        else:
            self.base = root
        self.cams = list(cams)
        self.imu_rows = self._read_csv(
            os.path.join(self.base, imu, "data.csv"), numeric=True
        )
        self.cam_rows = {
            c: self._read_csv(os.path.join(self.base, c, "data.csv")) for c in self.cams
        }
        gt_path = os.path.join(self.base, "state_groundtruth_estimate0", "data.csv")
        self.gt_rows = (
            self._read_csv(gt_path, numeric=True) if os.path.exists(gt_path) else []
        )

    @staticmethod
    def _read_csv(path, numeric=False):
        if numeric:
            # native one-pass parser (uvio_tpu_torch/native/csv_loader.cpp) for
            # the all-numeric files (IMU, groundtruth); python fallback
            # below handles everything (incl. string filename columns)
            try:
                from ..native import load_csv

                arr = load_csv(path)
            except (FileNotFoundError, ValueError):
                arr = None
            if arr is not None and len(arr):
                return list(arr)
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append(row)
        return rows

    def imu(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        """(t_s, gyro (3,), accel (3,)) — EuRoC column order w then a."""
        for r in self.imu_rows:
            t = float(r[0]) * 1e-9
            w = np.array([float(r[1]), float(r[2]), float(r[3])])
            a = np.array([float(r[4]), float(r[5]), float(r[6])])
            yield t, w, a

    def images(self, cam="cam0") -> Iterator[Tuple[float, str]]:
        """(t_s, image_path)."""
        for r in self.cam_rows[cam]:
            t = float(r[0]) * 1e-9
            yield t, os.path.join(self.base, cam, "data", r[1].strip())

    def groundtruth(self):
        """(t (N,), q_GtoI JPL (N,4), p (N,3), v (N,3), bg (N,3), ba (N,3)).

        EuRoC gt stores q_ItoG Hamilton [w,x,y,z]; converted to JPL
        q_GtoI [x,y,z,w] (same numbers, reordered — Hamilton q_ItoG and
        JPL q_GtoI represent the same rotation matrix mapping).
        """
        if not self.gt_rows:
            return None
        d = np.array([[float(x) for x in r] for r in self.gt_rows])
        t = d[:, 0] * 1e-9
        q_wxyz = d[:, 4:8]  # Hamilton q_ItoG (w,x,y,z)
        q_jpl = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
        return {
            "t": t,
            "q_GtoI": q_jpl,
            "p": d[:, 1:4],
            "v": d[:, 8:11],
            "bg": d[:, 11:14],
            "ba": d[:, 14:17],
        }


def run_euroc(dataset_root: str, config_dir: str, out_path: Optional[str] = None,
              max_frames: Optional[int] = None, use_klt: bool = True, device=None):
    """End-to-end EuRoC run: config + dataset -> TUM trajectory.

    Returns (t, q, p) arrays; writes TUM file if out_path given.
    (The `ros1_serial_msckf` deterministic offline equivalent.) The
    tracker and the manager run on `device` (None: the card).
    """
    import dataclasses

    import cv2

    from ..frontend.tracker import KLTTracker
    from ..manager import VioManager
    from ..uwb_manager import UVioConfig, UVioManager
    from .config import load_config

    cfg, extras = load_config(config_dir, device=device)
    cfg = dataclasses.replace(cfg, use_static_init=True, use_dynamic_init=True)
    mgr = UVioManager(cfg) if isinstance(cfg, UVioConfig) else VioManager(cfg)
    ds = EurocDataset(dataset_root)
    trackers = [
        KLTTracker(
            c.intrinsics, c.model,
            num_features=extras["num_pts"],
            grid=(extras["grid_y"], extras["grid_x"]),
            fast_thresh=extras["fast_threshold"],
            cam_id=i,
            device=mgr.device,
        )
        for i, c in enumerate(cfg.cameras[:1])  # mono tracking (stereo rd 2)
    ]

    img_it = ds.images("cam0")
    next_img = next(img_it, None)
    est_t, est_q, est_p = [], [], []
    frames = 0
    for (t, w, a) in ds.imu():
        mgr.feed_imu(t, w, a)
        while next_img is not None and next_img[0] <= t:
            ti, path = next_img
            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if img is not None:
                ids, uvs = trackers[0].feed(ti, img.astype(np.float32))
                mgr.feed_features(ti, [(ids, uvs)])
                if mgr.is_initialized:
                    q, p = mgr.get_pose()
                    est_t.append(ti)
                    est_q.append(q)
                    est_p.append(p)
                frames += 1
            next_img = next(img_it, None)
        if max_frames and frames >= max_frames:
            break
    out = (np.asarray(est_t), np.asarray(est_q), np.asarray(est_p))
    if out_path and len(est_t):
        from ..eval.traj import save_tum

        save_tum(out_path, *out)
    return out


# the estimator settings of `uvio_tpu`'s synthetic-dataset regression
# (`tests/test_euroc_reader.py`), over the vendored mono config
SYNTHETIC_OVERRIDES = {
    "max_cameras": "1", "use_stereo": "false", "max_slam": "0",
    "max_msckf_in_update": "40",
    "calib_cam_extrinsics": "false", "calib_cam_intrinsics": "false",
    "calib_cam_timeoffset": "false", "calib_imu_intrinsics": "false",
    "calib_imu_g_sensitivity": "false", "try_zupt": "false",
    # the rendered trajectory ramps in smoothly: low jerk threshold
    "init_window_time": "2.0", "init_imu_thresh": "0.5",
    "init_wait_for_jerk": "false",
    "init_dyn_use": "false", "num_pts": "150",
    "up_msckf_sigma_px": "2.0",
    "feat_rep_msckf": '"GLOBAL_3D"',
}


def write_synthetic_dataset(root: str, base_config: str, seed: int = 13, duration: float = 16.0,
                            still_time: float = 5.0, num_pts: int = 90):
    """Render an ASL-format dataset (`mav0/imu0`, `mav0/cam0` PNGs,
    `mav0/state_groundtruth_estimate0`) from the port's simulator (200 Hz
    IMU, 10 Hz camera, `circle_trajectory(duration, still_time)`) and a
    config directory beside it: `base_config`'s IMU chain and estimator
    config with `SYNTHETIC_OVERRIDES`, and an identity camera-IMU chain
    with the simulator's pinhole intrinsics. The stand-in for a real
    EuRoC sequence, as `uvio_tpu`'s own regression builds it. Returns
    (dataset_root, config_dir)."""
    import re
    import shutil

    import cv2

    from ..math import rot_to_quat
    from ..sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=num_pts, seed=seed),
        trajectory=circle_trajectory(duration=duration, still_time=still_time),
    )
    cam = sim.params.cameras[0]
    base = os.path.join(root, "mav0")
    for d in ("imu0", os.path.join("cam0", "data"), "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    imu_lines = ["#ts,wx,wy,wz,ax,ay,az"]
    cam_lines = ["#ts,filename"]
    ts = []
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        t, w, a = r
        ts.append(t)
        imu_lines.append(f"{int(round(t * 1e9))}," + ",".join(f"{x:.9f}" for x in np.concatenate([w, a])))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            tc = sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam
            sim.cur_cam_t = tc
            name = f"{int(round(tc * 1e9))}.png"
            cv2.imwrite(os.path.join(base, "cam0", "data", name), sim.render_image(tc).astype(np.uint8))
            cam_lines.append(f"{int(round(tc * 1e9))},{name}")
    # groundtruth at every IMU stamp in one spline evaluation
    # (`Simulator.get_gt_state`, batched)
    st = sim._state(ts)
    qj = rot_to_quat(st["R_GtoI"]).numpy()  # JPL [x,y,z,w] -> Hamilton q_ItoG [w,x,y,z]
    bt = np.array([b[0] for b in sim.bias_hist])
    bi = np.clip(np.searchsorted(bt, ts) - 1, 0, len(sim.bias_hist) - 1)
    bias = np.array([np.concatenate([sim.bias_hist[i][1], sim.bias_hist[i][2]]) for i in bi])
    rows = np.concatenate([st["p_IinG"].numpy(), qj[:, [3, 0, 1, 2]], st["v_IinG"].numpy(), bias], axis=1)
    gt_lines = ["#ts,px,py,pz,qw,qx,qy,qz,vx,vy,vz,bwx,bwy,bwz,bax,bay,baz"]
    gt_lines += [f"{int(round(t * 1e9))}," + ",".join(f"{x:.9f}" for x in row) for t, row in zip(ts, rows)]
    for sub, lines in (("imu0", imu_lines), ("cam0", cam_lines), ("state_groundtruth_estimate0", gt_lines)):
        with open(os.path.join(base, sub, "data.csv"), "w") as f:
            f.write("\n".join(lines))

    cfgdir = os.path.join(root, "config")
    os.makedirs(cfgdir, exist_ok=True)
    shutil.copy(os.path.join(base_config, "kalibr_imu_chain.yaml"), cfgdir)
    fx, fy, cx, cy = cam.intrinsics[:4]
    with open(os.path.join(cfgdir, "kalibr_imucam_chain.yaml"), "w") as f:
        f.write(f"""%YAML:1.0
cam0:
  T_imu_cam:
    - [1.0, 0.0, 0.0, 0.0]
    - [0.0, 1.0, 0.0, 0.0]
    - [0.0, 0.0, 1.0, 0.0]
    - [0.0, 0.0, 0.0, 1.0]
  camera_model: pinhole
  distortion_coeffs: [0.0, 0.0, 0.0, 0.0]
  distortion_model: radtan
  intrinsics: [{fx}, {fy}, {cx}, {cy}]
  resolution: [{cam.width}, {cam.height}]
  timeshift_cam_imu: 0.0
""")
    with open(os.path.join(base_config, "estimator_config.yaml")) as f:
        text = f.read()
    for k, v in SYNTHETIC_OVERRIDES.items():
        pat = re.compile(rf"^{k}:.*$", re.M)
        text = pat.sub(f"{k}: {v}", text) if pat.search(text) else text + f"\n{k}: {v}\n"
    with open(os.path.join(cfgdir, "estimator_config.yaml"), "w") as f:
        f.write(text)
    return root, cfgdir

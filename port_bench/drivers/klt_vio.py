"""The driver of system `klt_vio`: the port's image-to-pose path as a
camera rig runs it, raw frames and IMU samples in, a pose a frame out.

`Estimator` builds, from a configuration's YAML directory
(`load_config`), the port's plain `VioManager` (fused step, the
configuration's precision) and one `KLTTracker`, as the port's
`utils/euroc.run_euroc` does: the YAML's `num_pts`, grid,
`fast_threshold` and `histogram_method`, and a seeded `torch.Generator`
on the card for RANSAC. `feed_frame(k)` is the tracker's `feed` of frame
k (uint8, passed as float32 as `run_euroc` passes a decoded image)
followed by the manager's `feed_features`, which returns once the pose is
in host memory. The traffic is `traffic/euroc.py`'s, the judge
`check_klt.py`'s, against the plain references `reference/klt.py` and
`reference/slam_vio.py`.

After each frame `record` keeps what the judge compares: the filter's IMU
state, camera calibration and SLAM landmarks in a device buffer, and the
tracker's track table, its packed read-back and the emitted tracks on
the host.

A program whose tracker keeps no timing row (`KLTTracker.last_timing`)
cannot run the cell: `Estimator` raises when it is built.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import check_klt
# the judge's references load with the driver, before the window
from ..reference import config as ref_config, klt as _ref_klt, slam_vio as _ref_slam  # noqa: F401
from ..traffic.euroc import make_traffic  # noqa: F401  (the driver's traffic)

MODULES = ("utils.config", "manager", "frontend.tracker")
MIX_KEYS = ("warmup_s",)
# the frame's host stages from its start, as `frame_timing` times them
STAGES = (("convert_s", "frame to float32"), ("track_s", "tracker"), ("ingest_s", "manager ingest"),
          ("build_s", "host bundle build"), ("step_s", "step (dispatch to read-back)"),
          ("post_s", "host bookkeeping"))


class Estimator:
    def __init__(self, pkg, config: dict, traffic, root: str, device, dtype: Optional[str] = None):
        directory = os.path.join(root, "configs", config["estimator"])
        cfg, extras = pkg.utils.config.load_config(directory, device=str(device))
        cfg = dataclasses.replace(cfg, use_static_init=False, use_dynamic_init=False,
                                  dtype=dtype or config["dtype"])
        self.mgr = pkg.manager.VioManager(cfg)
        raw = ref_config.load(directory).raw
        cam = cfg.cameras[0]
        self.generator = torch.Generator(device=self.mgr.device).manual_seed(traffic.tracker_seed)
        self.tracker = pkg.frontend.tracker.KLTTracker(
            cam.intrinsics, cam.model, num_features=extras["num_pts"], grid=(extras["grid_y"], extras["grid_x"]),
            levels=int(config["tracker"]["pyramid_levels"]), fast_thresh=extras["fast_threshold"],
            histeq=str(raw.get("histogram_method", "HISTOGRAM")),
            device=self.mgr.device, generator=self.generator)
        if not hasattr(self.tracker, "last_timing"):
            raise RuntimeError("this program's KLTTracker keeps no timing row (last_timing), which the cell reads")
        self.traffic = traffic
        self.stream = traffic.stream
        self.images = traffic.images
        st = self.mgr.state
        self.S = self.mgr.layout.max_slam
        self.rows = torch.zeros((len(self.images), check_klt.row_width(self.S)), dtype=torch.float64,
                                device=st.cov.device)
        F = len(self.images)
        self.tables = [None] * F  # the track table (uv, active) after frame k
        self.readbacks = [None] * F  # frame k's packed read-back
        self.emitted = [None] * F  # frame k's (ids, uvs)
        self._stamps = (0.0, 0.0, 0.0, 0.0)
        self._out = None

    def graphs(self) -> list:
        """The graphed callables the run drives (`graphs.Graphed`)."""
        return [v for obj in (self.mgr, self.tracker) for v in vars(obj).values()
                if hasattr(v, "stats") and hasattr(v, "eager")]

    def graph_count(self) -> int:
        return sum(g.stats()["graphs"] for g in self.graphs())

    def initialize(self):
        g = self.traffic.gt0
        self.mgr.initialize_with_gt(self.stream.t_begin, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])

    def feed_imu(self, i: int):
        s = self.stream
        self.mgr.feed_imu(float(s.imu_t[i]), s.imu_w[i], s.imu_a[i])

    def feed_frame(self, k: int):
        """Frame k through the tracker and the filter to its pose in host
        memory."""
        t = float(self.stream.cam_t[k])
        t0 = time.perf_counter()
        img = self.images[k].astype(np.float32)
        t1 = time.perf_counter()
        ids, uvs = self.tracker.feed(t, img)
        t2 = time.perf_counter()
        self.mgr.feed_features(t, [(ids, uvs)])
        self._stamps = (t0, t1, t2, time.perf_counter())
        self._out = (ids, uvs)

    def frame_timing(self) -> dict:
        """The frame just fed (s): the conversion, the tracker's spans
        (`track_s` its whole `feed`), the estimator from `feed_features`'
        entry to its return (`estimator_s`) and the manager's spans:
        ingest, host bundle build, step from dispatch to the frame's
        read-back, and the read-back to the return."""
        t0, t1, t2, t3 = self._stamps
        tl, ml = self.tracker.last_timing, self.mgr.last_timing
        return {"convert_s": t1 - t0, "track_s": tl["track"], "upload_s": tl["upload"], "replay_s": tl["replay"],
                "readback_s": tl["readback"], "spawn_s": tl["spawn"], "estimator_s": t3 - t2,
                "ingest_s": ml["ingest"], "build_s": ml["build"], "step_s": ml["step"], "post_s": ml["post"]}

    def record(self, k: int):
        st = self.mgr.state
        self.rows[k].copy_(check_klt.program_row(st))
        tr = self.tracker
        self.tables[k] = (tr.uv.copy(), tr.active.copy())
        self.readbacks[k] = tr.last_readback
        self.emitted[k] = self._out

    def outputs(self, n_frames: int) -> check_klt.KltOutputs:
        """What the judge reads of the first `n_frames` frames."""
        return check_klt.KltOutputs(
            rows=self.rows[:n_frames].cpu().numpy(), final=check_klt.program_final(self.mgr),
            emitted=self.emitted[:n_frames], tables=self.tables[:n_frames], readbacks=self.readbacks[:n_frames],
            gumbel_device=str(self.generator.device), tracker_seed=self.traffic.tracker_seed,
            capacity=self.tracker.cap, levels=self.tracker.levels)


def control_outputs(pkg, config, traffic, root, device, n_frames) -> check_klt.KltOutputs:
    """The control in the program's place: the program with its filter in
    float32, the nearest precision below the configuration's float64 (the
    tracker runs in float32 either way). Where its covariance breaks (it
    raises `CovarianceError`), its outputs end with the frame before."""
    if config["dtype"] != "float64":
        raise ValueError("the control steps a float64 configuration down to float32")
    est = Estimator(pkg, config, traffic, root, device, dtype="float32")
    est.initialize()
    n = n_frames
    for kind, i in traffic.stream.events:
        if kind != "cam":
            est.feed_imu(i)
            continue
        before = est.mgr.state
        try:
            est.feed_frame(i)
        except pkg.manager.CovarianceError:
            est.mgr.state = before
            n = i
            break
        est.record(i)
        if i == n_frames - 1:
            break
    return est.outputs(n)


def judge(config, traffic, out, root) -> dict:
    """{number: (value, limit)} of `out` against the plain references
    (`check_klt.judge`, looked up when the check runs)."""
    return check_klt.judge(config, traffic, out, root)

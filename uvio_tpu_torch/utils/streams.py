"""Replay of the vendored recorded streams (`data/streams/{mono,stereo,uwb}`).

Each directory holds a config directory, the IMU, camera-track and UWB
streams the C++ reference estimator was run on (`imu.csv.gz`,
`cam.csv.gz`, `uwb.csv.gz`), its groundtruth-seeded start state
(`init.txt`), groundtruth (`gt.txt`) and the reference's own output
(`ref_est.txt`; for UWB the final anchor estimates `anchors_est.txt`,
truth in `uwb_truth.csv`). `stream_events` orders the streams exactly as
`uvio_tpu`'s regression (`tests/test_vendored_streams.py`) feeds them, so
a replay through the port meets the gates that regression sets against
the reference's output.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


def stream_events(data_dir: str, n_cameras: int, camimu_dt: float = 0.0, uwb: bool = False):
    """(init, events): the start state row of `init.txt` (t, q_GtoI,
    p, v, bg, ba) and the streams as one ordered list of
    ("imu", t, w, a) | ("uwb", t, ranges) | ("cam", t, [(ids, uvs)] per
    camera). A camera frame follows the first IMU sample at or after the
    NEXT frame's stamp, range sets the first IMU sample at or after their
    stamp plus `camimu_dt`, as the regression feeds them; frames up to
    the start time are dropped."""
    init = np.loadtxt(os.path.join(data_dir, "init.txt"))
    imu = np.loadtxt(os.path.join(data_dir, "imu.csv.gz"), delimiter=",")
    cam = np.loadtxt(os.path.join(data_dir, "cam.csv.gz"), delimiter=",")
    uwb_sets = []
    if uwb:
        rows = np.loadtxt(os.path.join(data_dir, "uwb.csv.gz"), delimiter=",")
        tv, idx = np.unique(rows[:, 0], return_index=True)
        for t_u in tv[np.argsort(idx)]:
            rr = rows[rows[:, 0] == t_u]
            uwb_sets.append((float(t_u), {int(a): float(d) for a, d in rr[:, 1:3]}))
        uwb_sets.sort(key=lambda s: s[0])
    frames = []
    tv, idx = np.unique(cam[:, 0], return_index=True)
    for t in tv[np.argsort(idx)]:
        rc = cam[cam[:, 0] == t]
        per_cam = []
        for c in range(n_cameras):
            r2 = rc[rc[:, 1] == c]
            per_cam.append((r2[:, 2].astype(np.int64), r2[:, 3:5]))
        frames.append((float(t), per_cam))
    frames.sort(key=lambda f: f[0])

    events = []
    fi = ui = 0
    for k in range(imu.shape[0]):
        t = float(imu[k, 0])
        events.append(("imu", t, imu[k, 1:4], imu[k, 4:7]))
        while ui < len(uwb_sets) and uwb_sets[ui][0] <= t - camimu_dt:
            events.append(("uwb", *uwb_sets[ui]))
            ui += 1
        while fi + 1 < len(frames) and frames[fi + 1][0] <= t:
            if frames[fi][0] > float(init[0]):
                events.append(("cam", *frames[fi]))
            fi += 1
    return init, events


def replay(mgr, data_dir: str, on_frame: Optional[Callable] = None):
    """Seed `mgr` with the stream's start state and feed it the stream
    (range sets too when it takes them). Returns (t, q_GtoI, p) of the
    state after every frame; `on_frame(mgr)` is called after each."""
    has_uwb = hasattr(mgr, "feed_uwb")
    init, events = stream_events(data_dir, len(mgr.cfg.cameras), float(mgr.cfg.camimu_dt), uwb=has_uwb)
    mgr.initialize_with_gt(init[0], init[1:5], init[5:8], init[8:11], init[11:14], init[14:17])
    est_t, est_q, est_p = [], [], []
    for ev in events:
        if ev[0] == "imu":
            mgr.feed_imu(*ev[1:])
        elif ev[0] == "uwb":
            mgr.feed_uwb(*ev[1:])
        else:
            mgr.feed_features(*ev[1:])
            q, p = mgr.get_pose()
            est_t.append(float(mgr._time_host))
            est_q.append(q)
            est_p.append(p)
            if on_frame is not None:
                on_frame(mgr)
    return np.asarray(est_t), np.asarray(est_q), np.asarray(est_p)


def anchor_errors(mgr, data_dir: str):
    """(ours, reference): RMS distance of the final anchor positions
    from `uwb_truth.csv`, for `mgr`'s state and for the C++ reference's
    `anchors_est.txt`."""
    truth = {}
    with open(os.path.join(data_dir, "uwb_truth.csv")) as f:
        for ln in f.read().strip().splitlines()[1:]:
            p = [float(x) for x in ln.split(",")]
            truth[int(p[0])] = np.asarray(p[1:4])
    ref_rows = np.atleast_2d(np.loadtxt(os.path.join(data_dir, "anchors_est.txt")))
    ref = np.sqrt(np.mean([np.linalg.norm(r[1:4] - truth[int(r[0])]) ** 2 for r in ref_rows]))
    anchors_p = mgr.state.anchors_p.cpu().numpy()
    ours = np.sqrt(np.mean([np.linalg.norm(anchors_p[slot] - truth[aid]) ** 2
                            for aid, slot in mgr.anchor_slot_by_id.items()]))
    return float(ours), float(ref)

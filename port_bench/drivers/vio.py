"""The estimator as a live vehicle runs it: sensors in, a pose a frame out.

`Estimator` builds the port's manager from a configuration's YAML
directory (`load_config`) and feeds it one sensor event at a time: an
IMU sample, a range set, a frame of tracks (`feed_features`, which
returns once the frame's pose is in host memory).

After each frame `record` keeps what the check compares: the filter's
IMU state, anchors and UWB lever arm in a device buffer, one copy a
frame. `outputs` hands them over in the layout-free form the plain
reference gives too (`reference/uvio.py`: `row`, `final`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Outputs:
    """What a run produced, on the host: `rows` (F, n) float64 the state
    after each frame (q p v bg ba, the configured anchors' positions,
    gammas and alphas, the lever arm), `final` the last frame's whole
    state by name, its covariance ordered [imu | lever arm | clones
    oldest first | anchors]."""

    rows: np.ndarray
    final: dict


class Estimator:
    FIELDS = ("q", "p", "v", "bg", "ba", "anchors_p", "anchors_gamma", "anchors_alpha", "uwb_p_IinU")

    def __init__(self, pkg, config: dict, traffic, root: str, device, dtype: Optional[str] = None):
        load_config = pkg.utils.config.load_config
        cfg, extras = load_config(os.path.join(root, "configs", config["estimator"]), device=str(device))
        cfg = dataclasses.replace(cfg, use_static_init=False, use_dynamic_init=False,
                                  dtype=dtype or config["dtype"])
        self.mgr = pkg.uwb_manager.UVioManager(cfg)
        self.anchor_slots = [self.mgr.anchor_slot_by_id[a.anchor_id] for a in cfg.anchors]
        self.extras = extras
        self.traffic = traffic
        self.stream = traffic.stream
        st = self.mgr.state
        self.sizes = [getattr(st, f).numel() for f in self.FIELDS]
        self.rows = torch.zeros((len(self.stream.cam_t), sum(self.sizes)), dtype=torch.float64,
                                device=st.cov.device)

    def graphs(self) -> list:
        """The graphed callables the run drives (`graphs.Graphed`)."""
        return [v for v in vars(self.mgr).values() if hasattr(v, "stats") and hasattr(v, "eager")]

    def graph_count(self) -> int:
        return sum(g.stats()["graphs"] for g in self.graphs())

    def initialize(self):
        g = self.traffic.gt0
        self.mgr.initialize_with_gt(self.stream.t_begin, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])

    def feed_imu(self, i: int):
        s = self.stream
        self.mgr.feed_imu(float(s.imu_t[i]), s.imu_w[i], s.imu_a[i])

    def feed_uwb(self, j: int):
        ranges = self.traffic.ranges(j)
        if ranges:
            self.mgr.feed_uwb(float(self.stream.uwb_t[j]), ranges)

    def feed_frame(self, k: int):
        """One frame through to its pose in host memory."""
        self.mgr.feed_features(float(self.stream.cam_t[k]), self.stream.tracks[k])

    def record(self, k: int):
        st = self.mgr.state
        self.rows[k].copy_(torch.cat([getattr(st, f).reshape(-1) for f in self.FIELDS]))

    def outputs(self, n_frames: int) -> Outputs:
        """The first `n_frames` rows and the last state, in the reference's
        form: the configured anchors in configuration order, the live
        clones oldest first."""
        rows = self.rows[:n_frames].cpu().numpy()
        q_v_b, anc_p, anc_g, anc_a, lever = np.split(rows, np.cumsum(self.sizes)[[4, 5, 6, 7]], axis=1)
        a = np.asarray(self.anchor_slots)
        A = anc_g.shape[1]
        rows = np.concatenate([q_v_b, anc_p.reshape(n_frames, A, 3)[:, a].reshape(n_frames, -1), anc_g[:, a],
                               anc_a[:, a], lever], axis=1)
        st = {f.name: getattr(self.mgr.state, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(self.mgr.state)}
        L = self.mgr.layout
        live = np.flatnonzero(st["clones_valid"])
        live = live[np.argsort(st["clones_t"][live], kind="stable")]
        lever_idx = np.arange(L.calib_uwb_off, L.calib_uwb_off + 3) if L.calib_uwb_extrinsics else np.zeros(0, int)
        order = np.concatenate([np.arange(15), lever_idx] + [L.clone_off + 6 * s + np.arange(6) for s in live]
                               + [L.anchor_off + 5 * s + np.arange(5) for s in a]).astype(int)
        final = {k: st[k] for k in ("q", "p", "v", "bg", "ba", "q_fej", "p_fej", "v_fej", "uwb_p_IinU")}
        final.update({k: st[k][live] for k in ("clones_t", "clones_q", "clones_p", "clones_q_fej", "clones_p_fej")})
        final.update({k: st[k][a] for k in ("anchors_p", "anchors_gamma", "anchors_alpha")})
        final["cov"] = st["cov"][np.ix_(order, order)]
        final["anchor_slots_extra"] = np.array([int(st["anchors_valid"].sum()) - int(st["anchors_valid"][a].sum())])
        final["anchors_missing"] = np.array([int((~st["anchors_valid"][a]).sum())])
        return Outputs(rows, final)


def run_events(est, n_frames: int, stop_on=()) -> int:
    """Feed the stream's events as fast as they go, through frame
    `n_frames - 1`, recording every frame. A frame that raises one of
    `stop_on` ends the run early, with the state as the frame before left
    it. Returns the frames recorded."""
    est.initialize()
    for kind, i in est.stream.events:
        if kind == "imu":
            est.feed_imu(i)
        elif kind == "uwb":
            est.feed_uwb(i)
        else:
            before = est.mgr.state
            try:
                est.feed_frame(i)
            except stop_on:
                est.mgr.state = before
                return i
            est.record(i)
            if i == n_frames - 1:
                return n_frames
    return n_frames

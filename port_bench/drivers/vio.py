"""The driver of system `vio`: the port's UWB-aided estimator as a live
vehicle runs it, sensors in, a pose a frame out.

`Estimator` builds the port's `UVioManager` from a configuration's YAML
directory (`load_config`) and feeds it one sensor event at a time: an
IMU sample, a range set, a frame of simulated tracks (`feed_features`,
which returns once the frame's pose is in host memory). The traffic is
`traffic/generate.py`'s, the judge `check.py`'s plain reference.

After each frame `record` keeps what the check compares: the filter's
IMU state, anchors and UWB lever arm in a device buffer, one copy a
frame. `outputs` hands them over in the layout-free form the plain
reference gives too (`check.Outputs`: `rows`, `final`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .. import check
from ..check import Outputs
# the judge's reference loads with the driver, before the window: set-up
# counts its import, and nothing of the check loads after the run's look
# for modules of JAX
from ..reference import config as _ref_config, uvio as _ref_uvio  # noqa: F401
from ..traffic.generate import make_traffic  # noqa: F401  (the driver's traffic)

MODULES = ("utils.config", "manager", "uwb_manager")
# the generator gives `range_drop_prob` a default: a mix states it all the same
MIX_KEYS = ("warmup_s", "range_drop_prob")
# the frame's host stages from its start, as `frame_timing` times them
STAGES = (("build_s", "host bundle build"), ("step_s", "step (dispatch to read-back)"),
          ("post_s", "host bookkeeping"))


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

    def frame_timing(self) -> dict:
        """The manager's `last_timing` of the frame just fed (s): host
        bundle build, step from dispatch to the frame's read-back, host
        bookkeeping."""
        lt = self.mgr.last_timing
        return {"build_s": lt["uwb"], "step_s": lt["propagation"], "post_s": lt["marginalization"]}

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


def control_outputs(pkg, config, traffic, root, device, n_frames) -> Outputs:
    """The control in the program's place: the program in float32, the
    nearest precision below the configuration's float64. Where its
    covariance breaks (it raises `CovarianceError`), its outputs end with
    the frame before: the control has failed, and these are its
    readings."""
    if config["dtype"] != "float64":
        raise ValueError("the control steps a float64 configuration down to float32")
    est = Estimator(pkg, config, traffic, root, device, dtype="float32")
    est.initialize()
    n = n_frames
    for kind, i in traffic.stream.events:
        if kind != "cam":
            getattr(est, f"feed_{kind}")(i)
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


def judge(config, traffic, out: Outputs, root) -> dict:
    """{number: (value, limit)} of `out` against the plain reference:
    `check.judge`, looked up when the check runs, so that a script that
    replaces it (`scripts/frame_spans.py --no-check`) skips the check."""
    return check.judge(config, traffic, out, root)

"""How `correct` is decided: the program's outputs against the plain
reference's, number by number, each against its limit.

The reference (`reference/uvio.py`) is a plain NumPy float64 UWB-aided
MSCKF written from OpenVINS's and UVIO's published method; it imports
nothing of the program. After the window it runs the same stream from
the same start (the same IMU samples, range sets and tracks, fed in the
same order), and the two filters are compared after every frame.

The numbers (`limits` in the configuration's file):

  pose_gap_m           largest distance between the two positions, any frame
  rot_gap_rad          largest angle between the two orientations, any frame
  state_gap            largest gap in v, bg, ba, the anchors' positions and
                       biases and the UWB lever arm, any frame
  final_gap_rel        largest gap in any float field of the last frame's
                       whole state (covariance, clones, first estimates)
                       over that field's largest magnitude
  final_mask_mismatch  exact: the live clones' times that differ (or are
                       missing on one side), and anchors missing or extra

The control (`drivers/vio.py` `control_outputs`) is the program itself
one step below the configuration's precision (its own float32 path for a
float64 configuration), judged the same way.

`passed` is every system's rule; the rest is the `vio` system's judge
(`drivers/vio.py` `judge`). This module imports the reference only when
it runs, so the harness, which imports `passed`, loads no system's
modules; the `vio` driver imports it with itself, before the window.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

_EXACT = ("clones_t", "anchor_slots_extra", "anchors_missing")


@dataclasses.dataclass
class Outputs:
    """What a run produced, on the host: `rows` (F, n) float64 the state
    after each frame (q p v bg ba, the configured anchors' positions,
    gammas and alphas, the lever arm), `final` the last frame's whole
    state by name, its covariance ordered [imu | lever arm | clones
    oldest first | anchors]."""

    rows: np.ndarray
    final: dict


def reference_outputs(config, traffic, root, n_frames) -> Outputs:
    """The plain reference over the stream's first `n_frames` frames."""
    from .reference import config as ref_config
    from .reference.uvio import UVio

    est = UVio(ref_config.load(os.path.join(root, "configs", config["estimator"])))
    s = traffic.stream
    g = traffic.gt0
    est.initialize_with_gt(s.t_begin, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])
    rows = []
    for kind, i in s.events:
        if kind == "imu":
            est.feed_imu(s.imu_t[i], s.imu_w[i], s.imu_a[i])
        elif kind == "uwb":
            ranges = traffic.ranges(i)
            if ranges:
                est.feed_uwb(s.uwb_t[i], ranges)
        else:
            ids, uvs = s.tracks[i][0]
            est.feed_features(float(s.cam_t[i]), ids, uvs)
            rows.append(est.row())
            if i == n_frames - 1:
                break
    final = est.final()
    final["anchor_slots_extra"] = np.array([0])
    final["anchors_missing"] = np.array([0])
    return Outputs(np.array(rows), final)


def _rot_gap(q, q_ref):
    """Rotation angle between unit quaternions, row by row."""
    s = np.sign(np.sum(q * q_ref, axis=1, keepdims=True))
    s[s == 0] = 1.0
    d = np.linalg.norm(q - s * q_ref, axis=1)
    return 4.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0))


def state_numbers(out: Outputs, ref: Outputs) -> dict:
    n = min(len(out.rows), len(ref.rows))
    a, b = out.rows[:n], ref.rows[:n]
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"the program's rows hold {a.shape[1]} numbers, the reference's {b.shape[1]}")
    num = {
        "pose_gap_m": float(np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1).max()) if n else math.inf,
        "rot_gap_rad": float(_rot_gap(a[:, 0:4], b[:, 0:4]).max()) if n else math.inf,
        "state_gap": float(np.abs(a[:, 7:] - b[:, 7:]).max()) if n else math.inf,
    }
    mism = 0
    for name in _EXACT:
        x, y = ref.final[name], out.final[name]
        mism += int(np.sum(x != y)) if x.shape == y.shape else max(x.size, y.size)
    rel = 0.0
    if ref.final["clones_t"].shape != out.final["clones_t"].shape:
        rel = math.inf  # the states are not laid alike: nothing to compare entry by entry
    else:
        for name, x in ref.final.items():
            if name in _EXACT:
                continue
            y = out.final[name].astype(np.float64)
            if not x.size:
                continue
            scale = float(np.abs(x).max())
            d = float(np.abs(y - x).max())
            rel = max(rel, d / scale if scale > 0 else d)
    num["final_gap_rel"] = rel
    num["final_mask_mismatch"] = mism
    return num


def judge(config, traffic, out: Outputs, root):
    """{number: (value, limit)} of `out`, the outputs of the program (or
    of the control in its place), against the reference."""
    numbers = state_numbers(out, reference_outputs(config, traffic, root, len(out.rows)))
    limits = config["limits"]
    return {k: (numbers[k], limits[k]) for k in limits}


def passed(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())

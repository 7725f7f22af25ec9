"""How `correct` is decided for system `klt_vio`: the program's tracker
and filter against the plain references, each with the program's own
inputs where the two could otherwise drift apart (teacher forcing).

The tracker, frame by frame (`reference/klt.py`): from the program's
track table before frame k and frames k-1 and k,

  lk_gap_px         the largest distance between the program's and the
                    reference's LK positions of a track both keep, where
                    the reference's LK has settled (its last step shorter
                    than `LK_CONVERGED`): a fixed count of iterations
                    stops a track that still moves wherever rounding has
                    taken it
  lk_drop_mismatch  exact: active tracks that one side's LK drops and
                    the other keeps
  ransac_flips      exact: tracks whose RANSAC verdict differs, RANSAC run
                    on the program's LK output with the program's own
                    Gumbel noise (recovered by replaying the tracker's
                    seeded generator on its device after the run), against
                    the hypothesis the program keeps: the first with the
                    most inliers (`program_picks`)
  detect_mismatch   exact: FAST-9 grid detections (cell picks and their
                    pixels) that differ, the grid's occupancy taken from
                    the program's tracks after RANSAC

A track whose LK iterate came within `EDGE_TOL` px of where its window
leaves the image (within `UNSETTLED_EDGE` px for a track still moving at
its last iteration, whose iterates rounding has moved), or whose gradient
matrix's smaller eigenvalue lies within `EIG_TOL` of the gate, is left
out of the first two (its verdict turns on the last bit); so is, from
`ransac_flips`, a track whose epipolar residual lies nearer the
threshold's than the float32 rounding of the estimator's own residual:
`RANSAC_ULPS` ulps of the sum of its terms' magnitudes. The counts
of these and of the unsettled tracks are printed to standard error.

The filter (`reference/slam_vio.py`) is fed the tracks the program's
tracker emitted, with the same IMU samples in the same order, and
compared after every frame:

  pose_gap_m           largest distance between the two positions
  rot_gap_rad          largest angle between the two orientations
  state_gap            largest gap in v, bg, ba, the time offset, the
                       extrinsics (q_ItoC as 4 numbers, p_IinC), the
                       intrinsics and every landmark both hold (its
                       anchored inverse depth), any frame
  final_gap_rel        largest gap in any float field of the last state
                       (covariance, clones, landmarks, first estimates)
                       over that field's largest magnitude
  final_mask_mismatch  exact: landmarks held by one side only or anchored
                       at another clone, summed over the frames, and the
                       last state's clone times that differ

The control (`drivers/klt_vio.py` `control_outputs`) is the program with
its filter one step below the configuration's precision, judged the
same way.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import List

import numpy as np
import torch

WIDTH = 32  # q p v bg ba, dt, q_ItoC p_IinC, intrinsics
EDGE_TOL = 1e-3  # px
LK_CONVERGED = 1e-2  # px: a level-0 LK whose last step was longer has not settled
UNSETTLED_EDGE = 1.0  # px
EIG_TOL = 1e-4  # of the eigenvalue gate
# float32 ulps of the sum of its terms' magnitudes by which the program's
# epipolar residual x2^T F x1 may lie from the reference's: it forms the
# residual in float32, from its own undistorted points and an 8-point F
# whose conditioning magnifies their last bits. On an NVIDIA H100, with
# the program's undistortion, F and Sampson distances recomputed on the
# card for the hypothesis it kept, the largest gap of a track within a
# factor of 4 of the threshold was 252 ulps over 4 seeds of the cell
# (480 frames each); the band is twice that. A track whose residual lies
# that near the threshold's is undecided
RANSAC_ULPS = 504
F32_EPS = 2.0 ** -24
RANSAC_HYPOTHESES = 64
CHUNK = 16  # frames the tracker's check takes at once


@dataclasses.dataclass
class KltOutputs:
    """What a run produced, on the host. `rows` (F, WIDTH + 6 S) the
    filter after each frame (`program_row`), `final` its last state by
    name (covariance [imu | calib | clones oldest first | landmarks by
    id]); per frame the tracker's emitted (ids, uvs), its track table
    after the frame (uv, active) and its packed read-back; the
    device and seed of its RANSAC generator, its capacity and levels."""

    rows: np.ndarray
    final: dict
    emitted: List[tuple]
    tables: List[tuple]
    readbacks: List[np.ndarray]
    gumbel_device: str
    tracker_seed: int
    capacity: int
    levels: int


def row_width(max_slam: int) -> int:
    return WIDTH + 6 * max_slam


def program_row(st) -> torch.Tensor:
    """The filter's state as one float64 row: `WIDTH` numbers, then each
    SLAM slot's value (3), id, valid flag and anchor clone's time."""
    f64 = torch.float64
    anchor_t = torch.index_select(st.clones_t, 0, st.slam_anchor_slot.long().clamp(min=0).reshape(-1))
    return torch.cat([x.reshape(-1).to(f64) for x in (
        st.q, st.p, st.v, st.bg, st.ba, st.calib_dt, st.calib_cam_q[0], st.calib_cam_p[0], st.calib_cam_intr[0],
        st.slam_p, st.slam_id, st.slam_valid, anchor_t)])


def program_final(mgr) -> dict:
    """The manager's last state in the reference's form and order."""
    st = {f.name: getattr(mgr.state, f.name).detach().cpu().numpy() for f in dataclasses.fields(mgr.state)}
    L = mgr.layout
    live = np.flatnonzero(st["clones_valid"])
    live = live[np.argsort(st["clones_t"][live], kind="stable")]
    lms = np.flatnonzero(st["slam_valid"])
    lms = lms[np.argsort(st["slam_id"][lms], kind="stable")]
    order = np.concatenate([np.arange(15), np.arange(L.calib_off, L.calib_off + 15)]
                           + [L.clone_off + 6 * s + np.arange(6) for s in live]
                           + [L.slam_off + 3 * s + np.arange(3) for s in lms]).astype(int)
    out = {k: st[k].astype(np.float64) for k in ("q", "p", "v", "bg", "ba", "q_fej", "p_fej", "v_fej")}
    out.update(calib_dt=np.asarray(st["calib_dt"], np.float64).reshape(1), calib_q=st["calib_cam_q"][0],
               calib_p=st["calib_cam_p"][0], calib_intr=st["calib_cam_intr"][0])
    out.update({k: st[k][live] for k in ("clones_t", "clones_q", "clones_p", "clones_q_fej", "clones_p_fej")})
    out.update(slam_id=st["slam_id"][lms].astype(np.int64), slam_anchor_t=st["clones_t"][st["slam_anchor_slot"][lms]],
               slam_p=st["slam_p"][lms], slam_p_fej=st["slam_p_fej"][lms])
    out["cov"] = st["cov"][np.ix_(order, order)]
    return {k: np.asarray(v) for k, v in out.items()}


def program_landmarks(row: np.ndarray, S: int) -> dict:
    """{feature id: (value, anchor time)} of one program row."""
    lm = row[WIDTH:]
    vals, ids, valid, at = lm[:3 * S].reshape(S, 3), lm[3 * S:4 * S], lm[4 * S:5 * S], lm[5 * S:6 * S]
    return {int(ids[s]): (vals[s], float(at[s])) for s in range(S) if valid[s] != 0}


# --- the tracker ---------------------------------------------------------------------

def gumbel_replay(out: KltOutputs, n_frames: int):
    """The Gumbel noise each tracking frame's RANSAC took, in order: the
    tracker's generator replayed on its device (one draw a frame after
    the first), as standard Gumbel noise computed there."""
    dev = torch.device(out.gumbel_device)
    gen = torch.Generator(device=dev).manual_seed(out.tracker_seed)
    tiny = torch.finfo(torch.float32).tiny
    for _ in range(1, n_frames):
        u = torch.rand((RANSAC_HYPOTHESES, 8, out.capacity), generator=gen, device=dev)
        yield (-torch.log(-torch.log(torch.clamp(u, min=tiny)))).cpu()


def program_picks(lo, hi) -> np.ndarray:
    """The hypotheses the program's RANSAC may have kept: it keeps the
    first of those with the most inliers (`argmax`), and hypothesis h
    counts between lo[h] and hi[h] inliers as its undecided tracks fall.
    h can be first only if its most can beat every earlier one's least
    and tie every later one's; with no undecided track that is the
    reference's own first best alone."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    before = np.concatenate([[-1], np.maximum.accumulate(lo)[:-1]])
    after = np.concatenate([np.maximum.accumulate(lo[::-1])[::-1][1:], [-1]])
    return np.flatnonzero((hi > before) & (hi >= after))


def tracker_numbers(config, traffic, out: KltOutputs, root) -> dict:
    from .reference import config as ref_config, klt

    est = ref_config.load(os.path.join(root, "configs", config["estimator"]))
    raw = est.raw
    gy, gx = int(raw.get("grid_y", 5)), int(raw.get("grid_x", 5))
    N = out.capacity
    per_cell = max(1, min(4, math.ceil(N / (gy * gx))))
    thresh = float(raw.get("fast_threshold", 20.0))
    intr = torch.tensor(est.cameras[0].intrinsics, dtype=torch.float32)
    thr2 = (2.0 / float(max(est.cameras[0].intrinsics[:2]))) ** 2
    n = len(out.readbacks)
    num = {"lk_gap_px": 0.0, "lk_drop_mismatch": 0, "ransac_flips": 0, "detect_mismatch": 0}
    amb_lk = amb_ransac = unconverged = 0
    noise = gumbel_replay(out, n)
    for c0 in range(0, n, CHUNK):
        ks = np.arange(c0, min(n, c0 + CHUNK))
        frames = np.arange(max(c0 - 1, 0), ks[-1] + 1)  # the chunk's frames and the one before
        eq = torch.stack([klt.equalize(torch.as_tensor(traffic.images[k], dtype=torch.float32)) for k in frames])
        at = {int(k): i for i, k in enumerate(frames)}
        # detections, the grid's occupancy from the program's tracks after RANSAC
        occ_uv = np.zeros((len(ks), N, 2), np.float32)
        occ = np.zeros((len(ks), N), bool)
        det = []
        for j, k in enumerate(ks):
            rb = out.readbacks[k]
            if k > 0:
                occ_uv[j], occ[j] = rb[:N, :2], rb[:N, 2] != 0
                rb = rb[N:]
            det.append(rb)
        d_uv, d_ok = klt.grid_detect(klt.fast_score(eq[[at[int(k)] for k in ks]], thresh), gy, gx, per_cell, occ_uv, occ)
        for j, rb in enumerate(det):
            p_ok, r_ok = rb[:, 2] != 0, d_ok[j].numpy()
            num["detect_mismatch"] += int(np.sum(p_ok != r_ok)
                                          + np.sum(np.any(rb[:, :2] != d_uv[j].numpy(), axis=1) & p_ok & r_ok))
        ks = ks[ks > 0]
        if not len(ks):
            continue
        # LK from each frame's table before it
        pyr = klt.pyramid(eq, out.levels)
        prev, cur = [at[int(k) - 1] for k in ks], [at[int(k)] for k in ks]
        uv0 = np.stack([out.tables[k - 1][0] for k in ks])
        act = np.stack([out.tables[k - 1][1] for k in ks])
        rb = np.stack([out.readbacks[k][:N] for k in ks])
        uvp, trk, okp = rb[..., :2], rb[..., 2] != 0, rb[..., 3] != 0
        f = torch.arange(len(ks)).repeat_interleave(N)
        uvr, okr, eig, margin, last = klt.lk([lv[prev] for lv in pyr], [lv[cur] for lv in pyr], f,
                                             torch.as_tensor(uv0.reshape(-1, 2)), torch.as_tensor(act.reshape(-1)))
        uvr = uvr.numpy().reshape(len(ks), N, 2)
        okr = okr.numpy().reshape(len(ks), N)
        moving = last >= LK_CONVERGED
        amb = ((margin < EDGE_TOL) | (moving & (margin < UNSETTLED_EDGE))
               | ((eig - klt.LK_MIN_EIG).abs() < EIG_TOL * klt.LK_MIN_EIG)).numpy().reshape(len(ks), N)
        moving = moving.numpy().reshape(len(ks), N)
        amb_lk += int(np.sum(act & amb))
        unconverged += int(np.sum(act & okr & ~amb & moving))
        both = act & okp & okr & ~amb & ~moving
        if both.any():
            num["lk_gap_px"] = max(num["lk_gap_px"], float(np.linalg.norm(uvp[both] - uvr[both], axis=1).max()))
        num["lk_drop_mismatch"] += int(np.sum(act & ~amb & (okp != okr)))
        # RANSAC on the program's LK output with its noise
        valid = act & okp
        xn = klt.undistort(intr, torch.as_tensor(np.concatenate([uv0, uvp], axis=1)))
        g = torch.stack([next(noise) for _ in ks])
        d, r, den, terms = (x.numpy() for x in klt.ransac_distances(xn[:, :N], xn[:, N:], torch.as_tensor(valid), g))
        undecided = np.abs(r - np.sqrt(thr2 * den)) < RANSAC_ULPS * F32_EPS * terms
        for j in range(len(ks)):
            v = valid[j]
            if v.sum() < klt.RANSAC_MIN_VALID:
                num["ransac_flips"] += int(np.sum(v != trk[j]))
                continue
            inl = (d[j] < thr2) & v
            near = undecided[j] & v
            best = int(np.argmax(inl.sum(1)))
            could = program_picks((inl & ~near).sum(1), (inl | near).sum(1))
            flips = [int(np.sum((inl[h] != trk[j]) & v & ~near[h])) for h in could]
            num["ransac_flips"] += min(flips)
            amb_ransac += int(near[best].sum())
            if min(flips):
                h = could[int(np.argmin(flips))]
                off = (np.abs(r[j][h] - np.sqrt(thr2 * den[j][h])) / (F32_EPS * terms[j][h]))[(inl[h] != trk[j]) & v]
                print(f"check_klt: frame {ks[j]}: {min(flips)} RANSAC flips, {float(off.min()):.3g} float32 ulps "
                      "of their residuals' terms from the threshold", file=sys.stderr)
    print(f"check_klt: {amb_lk} LK verdicts and {amb_ransac} RANSAC verdicts at the edge of a gate, "
          f"{unconverged} LK positions still moving, not judged", file=sys.stderr)
    return num


# --- the filter ------------------------------------------------------------------------

def reference_run(config, traffic, out: KltOutputs, root):
    """The plain filter fed the program's emitted tracks: (rows, landmarks
    per frame, the last state)."""
    from .reference import config as ref_config
    from .reference.slam_vio import SlamVio

    est = SlamVio(ref_config.load(os.path.join(root, "configs", config["estimator"])))
    s, g = traffic.stream, traffic.gt0
    est.initialize_with_gt(s.t_begin, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])
    n = len(out.emitted)
    rows, lms = [], []
    for kind, i in s.events:
        if kind == "imu":
            est.feed_imu(s.imu_t[i], s.imu_w[i], s.imu_a[i])
            continue
        ids, uvs = out.emitted[i]
        est.feed_features(float(s.cam_t[i]), ids, uvs)
        rows.append(est.row())
        lms.append(est.landmarks())
        if i == n - 1:
            break
    return np.array(rows), lms, est.final()


def _rot_gap(q, q_ref):
    s = np.sign(np.sum(q * q_ref, axis=1, keepdims=True))
    s[s == 0] = 1.0
    return 4.0 * np.arcsin(np.clip(np.linalg.norm(q - s * q_ref, axis=1) / 2.0, 0.0, 1.0))


def filter_numbers(out: KltOutputs, ref_rows, ref_lms, ref_final) -> dict:
    S = (out.rows.shape[1] - WIDTH) // 6
    n = min(len(out.rows), len(ref_rows))
    a, b = out.rows[:n, :WIDTH], ref_rows[:n]
    if not n:
        return {k: math.inf for k in ("pose_gap_m", "rot_gap_rad", "state_gap", "final_gap_rel")} | {
            "final_mask_mismatch": 1}
    gap = float(np.abs(a[:, 7:] - b[:, 7:]).max())
    mism = 0
    for k in range(n):
        mine, ref = program_landmarks(out.rows[k], S), ref_lms[k]
        mism += len(set(mine) ^ set(ref))
        for fid in set(mine) & set(ref):
            if mine[fid][1] != ref[fid][1]:
                mism += 1
            else:
                gap = max(gap, float(np.abs(mine[fid][0] - ref[fid][0]).max()))
    f, r = out.final, ref_final
    exact = ("clones_t", "slam_id", "slam_anchor_t")
    for name in exact:
        mism += int(np.sum(f[name] != r[name])) if f[name].shape == r[name].shape else max(f[name].size, r[name].size)
    rel = 0.0
    if any(f[k].shape != r[k].shape for k in exact) or f["cov"].shape != r["cov"].shape:
        rel = math.inf  # the states are not laid alike
    else:
        for name, x in r.items():
            if name in exact or not np.size(x):
                continue
            scale = float(np.abs(x).max())
            d = float(np.abs(np.asarray(f[name], np.float64) - x).max())
            rel = max(rel, d / scale if scale > 0 else d)
    return {"pose_gap_m": float(np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1).max()),
            "rot_gap_rad": float(_rot_gap(a[:, 0:4], b[:, 0:4]).max()), "state_gap": gap,
            "final_gap_rel": rel, "final_mask_mismatch": mism}


def judge(config, traffic, out: KltOutputs, root) -> dict:
    """{number: (value, limit)} of `out`, the outputs of the program (or of
    the control in its place), against the references."""
    t0 = time.perf_counter()
    numbers = tracker_numbers(config, traffic, out, root)
    t1 = time.perf_counter()
    numbers.update(filter_numbers(out, *reference_run(config, traffic, out, root)))
    print(f"check_klt: tracker {t1 - t0:.1f} s, filter {time.perf_counter() - t1:.1f} s", file=sys.stderr)
    limits = config["limits"]
    return {k: (numbers[k], limits[k]) for k in limits}

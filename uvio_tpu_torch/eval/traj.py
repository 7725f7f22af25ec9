"""Trajectory evaluation toolkit.

Port of `uvio_tpu/eval/traj.py`, the equivalent of `ov_eval` (`src/alignment/AlignTrajectory.{h,cpp}`,
`src/calc/ResultTrajectory.{h,cpp}`): timestamp intersection, Umeyama
trajectory alignment (none / posyaw / se3 / sim3), ATE (3D and 2D),
RPE over segment lengths, and NEES against groundtruth with
covariances.

numpy throughout (evaluation is offline host-side analysis); the two
SO(3) maps are the port's `math.quat_ops` on float64 CPU tensors.
Orientations are JPL quaternions q_GtoI `[x,y,z,w]` as recorded by the
estimator (the reference's text format).
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import log_so3, quat_to_rot


def _rot(q):
    """Rotation matrices R_GtoI of JPL quaternions (..., 4), as numpy."""
    return quat_to_rot(torch.as_tensor(np.asarray(q), dtype=torch.float64)).numpy()


def _log(R):
    """so(3) vectors of rotation matrices (..., 3, 3), as numpy."""
    return log_so3(torch.as_tensor(np.asarray(R), dtype=torch.float64)).numpy()


def intersect(t_est, t_gt, tol=1e-3):
    """Indices pairing est and gt samples with |dt| < tol (Loader
    timestamp intersection)."""
    i_est, i_gt = [], []
    j = 0
    for i, t in enumerate(t_est):
        while j < len(t_gt) - 1 and t_gt[j] < t - tol:
            j += 1
        if abs(t_gt[j] - t) <= tol:
            i_est.append(i)
            i_gt.append(j)
    return np.asarray(i_est, int), np.asarray(i_gt, int)


def umeyama_align(p_est, p_gt, method="se3"):
    """Umeyama closed-form alignment est->gt.

    method: none | posyaw | se3 | sim3 (AlignTrajectory.h:59-115).
    Returns (s, R, t) with p_aligned = s R p_est + t.
    """
    if method == "none":
        return 1.0, np.eye(3), np.zeros(3)
    mu_e = p_est.mean(0)
    mu_g = p_gt.mean(0)
    xe = p_est - mu_e
    xg = p_gt - mu_g
    C = xg.T @ xe / len(p_est)
    U, S, Vt = np.linalg.svd(C)
    Ssel = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Ssel[2, 2] = -1
    R = U @ Ssel @ Vt
    if method == "posyaw":
        # restrict to yaw-only rotation: maximize trace of Rz^T C
        yaw = np.arctan2(C[1, 0] - C[0, 1], C[0, 0] + C[1, 1])
        # note: solves argmax over Rz of trace(Rz^T C)
        cz, sz = np.cos(yaw), np.sin(yaw)
        R = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    if method == "sim3":
        var_e = (xe**2).sum() / len(p_est)
        s = np.trace(np.diag(S) @ Ssel) / var_e
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate(t_est, q_est, p_est, t_gt, q_gt, p_gt, method="se3"):
    """ATE RMSE after alignment. Returns dict with rmse_pos (m),
    rmse_ori (deg), and per-sample errors."""
    ie, ig = intersect(t_est, t_gt)
    pe, pg = p_est[ie], p_gt[ig]
    qe, qg = q_est[ie], q_gt[ig]
    s, R, t = umeyama_align(pe, pg, method)
    pa = (s * (R @ pe.T)).T + t
    err_p = np.linalg.norm(pa - pg, axis=1)
    # orientation error: R_err = R_gt^T (R_align R_est)  (est frames map
    # through the alignment rotation)
    Re = _rot(qe)  # R_GtoI est
    Rg = _rot(qg)
    # p_aligned frame: R_est' = R_est @ R_align^T  (global frame rotated)
    Rea = np.einsum("nij,kj->nik", Re, R)
    dR = np.einsum("nij,njk->nik", Rg, Rea.transpose(0, 2, 1))
    ang = np.linalg.norm(_log(dR), axis=1)
    return {
        "rmse_pos": float(np.sqrt(np.mean(err_p**2))),
        "rmse_ori_deg": float(np.degrees(np.sqrt(np.mean(ang**2)))),
        "mean_pos": float(err_p.mean()),
        "err_pos": err_p,
        "err_ori_deg": np.degrees(ang),
        "n": len(ie),
    }


def ate_2d(t_est, q_est, p_est, t_gt, q_gt, p_gt, method="se3"):
    """ATE in the x-y plane + yaw-only orientation error
    (`ResultTrajectory::calculate_ate_2d`, ResultTrajectory.cpp: the
    position error is the 2D norm, the orientation error the z
    component of log_so3(R_est^T R_gt), both after alignment)."""
    ie, ig = intersect(t_est, t_gt)
    pe, pg = p_est[ie], p_gt[ig]
    qe, qg = q_est[ie], q_gt[ig]
    s, R, t = umeyama_align(pe, pg, method)
    pa = (s * (R @ pe.T)).T + t
    err_p2 = np.linalg.norm(pa[:, :2] - pg[:, :2], axis=1)
    Re = _rot(qe)
    Rg = _rot(qg)
    # same composition as ate(): dR = Rg @ Rea^T so the yaw error is
    # measured in the same (global) frame as the 3D metric
    Rea = np.einsum("nij,kj->nik", Re, R)
    dR = np.einsum("nij,njk->nik", Rg, Rea.transpose(0, 2, 1))
    yaw = _log(dR)[:, 2]
    return {
        "rmse_pos": float(np.sqrt(np.mean(err_p2**2))),
        "rmse_ori_deg": float(np.degrees(np.sqrt(np.mean(yaw**2)))),
        "mean_pos": float(err_p2.mean()),
        "err_pos": err_p2,
        "err_yaw_deg": np.degrees(yaw),
        "n": len(ie),
    }


def rpe(t_est, q_est, p_est, t_gt, q_gt, p_gt, segment_lengths=(8, 16, 24, 32, 40)):
    """Relative pose error per segment length (ResultTrajectory::
    calculate_rpe semantics: segments by traveled gt distance)."""
    ie, ig = intersect(t_est, t_gt)
    pe, pg = p_est[ie], p_gt[ig]
    Re, Rg = _rot(q_est[ie]), _rot(q_gt[ig])
    dist = np.concatenate([[0], np.cumsum(np.linalg.norm(np.diff(pg, axis=0), axis=1))])
    out = {}
    for L in segment_lengths:
        errs_p, errs_r = [], []
        for i in range(len(pg)):
            j = np.searchsorted(dist, dist[i] + L)
            if j >= len(pg):
                break
            # relative transforms
            dp_gt = Rg[i] @ (pg[j] - pg[i])
            dp_es = Re[i] @ (pe[j] - pe[i])
            dR_gt = Rg[j] @ Rg[i].T
            dR_es = Re[j] @ Re[i].T
            errs_p.append(np.linalg.norm(dp_gt - dp_es))
            dR = dR_gt @ dR_es.T
            errs_r.append(np.linalg.norm(_log(dR)))
        if errs_p:
            out[L] = {
                "rmse_pos": float(np.sqrt(np.mean(np.square(errs_p)))),
                "rmse_ori_deg": float(np.degrees(np.sqrt(np.mean(np.square(errs_r))))),
                "n": len(errs_p),
            }
    return out


def nees(q_est, p_est, cov_ori, cov_pos, q_gt, p_gt):
    """Normalized estimation error squared for ori/pos separately
    (ResultTrajectory::calculate_nees). cov_* are (N,3,3) marginals.
    No alignment: assumes same frame (simulation use)."""
    Re, Rg = _rot(q_est), _rot(q_gt)
    dR = np.einsum("nij,njk->nik", Rg, Re.transpose(0, 2, 1))
    e_th = _log(dR)
    e_p = p_gt - p_est
    nees_o = np.einsum("ni,nij,nj->n", e_th, np.linalg.inv(cov_ori), e_th)
    nees_p = np.einsum("ni,nij,nj->n", e_p, np.linalg.inv(cov_pos), e_p)
    return nees_o, nees_p


def load_tum(path):
    """TUM file: t x y z qx qy qz qw -> (t, q, p)."""
    d = np.loadtxt(path, comments="#")
    return d[:, 0], d[:, 4:8], d[:, 1:4]


def save_tum(path, t, q, p):
    """Write a TUM trajectory (the reference's recording format,
    `ROS1Visualizer.cpp:117-143` / `Recorder.h`)."""
    with open(path, "w") as f:
        f.write("# timestamp(s) tx ty tz qx qy qz qw\n")
        for i in range(len(t)):
            f.write(
                f"{t[i]:.9f} {p[i,0]:.9f} {p[i,1]:.9f} {p[i,2]:.9f} "
                f"{q[i,0]:.9f} {q[i,1]:.9f} {q[i,2]:.9f} {q[i,3]:.9f}\n"
            )

"""Simulation-consistency analysis (`error_simulation` equivalent).

Port of `uvio_tpu/eval/simres.py`; mirrors `ov_eval::ResultSimulation`
(`ov_eval/src/calc/ResultSimulation.{h,cpp}`): given the three recorded streams of a
simulation run — estimated total state, its 1-sigma std, and the exact
simulator groundtruth (see `recorder.StateRecorder`) — computes

  * per-component error vs time with 3-sigma bound violation rates
    (plot_state_err behavior, rendered as statistics),
  * average NEES for orientation and position (plot_state_nees),
  * calibration-convergence summary for any extra recorded columns
    (plot_timeoff/plot_cam_instrinsics/plot_cam_extrinsics behavior).

The filter is consistent when NEES ~= dof (3) and ~99.7% of errors sit
inside 3 sigma.
"""

from __future__ import annotations

import numpy as np

from .recorder import load_state_file, load_std_file
from .traj import _rot, intersect


def _ori_err(q_est, q_gt):
    """so(3) orientation error vectors est vs gt (JPL q_GtoI)."""
    errs = np.zeros((len(q_est), 3))
    for i in range(len(q_est)):
        R_e = _rot(q_est[i])
        R_g = _rot(q_gt[i])
        dR = R_e @ R_g.T
        # log map (vee of skew part, stable for small errors)
        c = (np.trace(dR) - 1.0) / 2.0
        c = np.clip(c, -1.0, 1.0)
        th = np.arccos(c)
        if th < 1e-9:
            w = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
        else:
            w = th / (2 * np.sin(th)) * np.array(
                [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]
            )
        errs[i] = w
    return errs


def error_simulation(est_path, std_path, gt_path):
    """Full consistency report; returns a dict of metrics."""
    t_e, q_e, p_e, v_e, bg_e, ba_e, ex_e = load_state_file(est_path)
    t_s, sq, sp, sv, sbg, sba, ex_s = load_std_file(std_path)
    t_g, q_g, p_g, v_g, bg_g, ba_g, ex_g = load_state_file(gt_path)

    ie, ig = intersect(t_e, t_g)
    q_e, p_e, v_e, bg_e, ba_e = q_e[ie], p_e[ie], v_e[ie], bg_e[ie], ba_e[ie]
    q_g, p_g, v_g, bg_g, ba_g = q_g[ig], p_g[ig], v_g[ig], bg_g[ig], ba_g[ig]
    ex_e, ex_g = ex_e[ie], ex_g[ig]
    ies, igs = intersect(t_e[ie], t_s)
    sq, sp, sv, sbg, sba = sq[igs], sp[igs], sv[igs], sbg[igs], sba[igs]
    ex_s = ex_s[igs]

    e_ori = _ori_err(q_e, q_g)[ies]
    e_pos = (p_e - p_g)[ies]
    e_v = (v_e - v_g)[ies]
    e_bg = (bg_e - bg_g)[ies]
    e_ba = (ba_e - ba_g)[ies]

    def block(err, std, name):
        std = np.maximum(std, 1e-12)
        inside = np.mean(np.abs(err) <= 3.0 * std)
        nees = np.mean(np.sum((err / std) ** 2, axis=1))
        return {
            f"{name}_rmse": float(np.sqrt(np.mean(np.sum(err**2, 1)))),
            f"{name}_nees": float(nees),
            f"{name}_3sigma_frac": float(inside),
        }

    out = {"n": int(len(e_pos))}
    out.update(block(e_ori, sq, "ori"))
    out.update(block(e_pos, sp, "pos"))
    out.update(block(e_v, sv, "vel"))
    out.update(block(e_bg, sbg, "bg"))
    out.update(block(e_ba, sba, "ba"))

    # calibration convergence: any extra recorded columns (dt, cam
    # intrinsics/extrinsics, imu intrinsics) — final error + whether
    # |err| shrank from the first to the last decile of the run.
    k = min(ex_e.shape[1], ex_g.shape[1])
    calib = []
    if k > 0:
        d = ex_e[:, :k] - ex_g[:, :k]
        n10 = max(1, len(d) // 10)
        first = np.abs(d[:n10]).mean(0)
        last = np.abs(d[-n10:]).mean(0)
        for j in range(k):
            calib.append(
                dict(
                    column=j,
                    final_abs_err=float(np.abs(d[-1, j])),
                    initial_mean_abs=float(first[j]),
                    final_mean_abs=float(last[j]),
                    converged=bool(last[j] <= first[j] + 1e-12),
                )
            )
    out["calib"] = calib
    return out


def format_report(res):
    lines = [f"[error_simulation] matched samples: {res['n']}"]
    for name, dof in (("ori", 3), ("pos", 3), ("vel", 3), ("bg", 3), ("ba", 3)):
        lines.append(
            f"  {name:3s}: rmse = {res[f'{name}_rmse']:.5f} | "
            f"NEES = {res[f'{name}_nees']:.2f} (dof {dof}) | "
            f"within 3sigma = {res[f'{name}_3sigma_frac'] * 100:.1f} %"
        )
    if res["calib"]:
        n_conv = sum(c["converged"] for c in res["calib"])
        lines.append(
            f"  calib: {n_conv}/{len(res['calib'])} columns converged "
            "(|err| last decile <= first decile)"
        )
        for c in res["calib"]:
            lines.append(
                f"    col {c['column']:2d}: |err| {c['initial_mean_abs']:.5f} -> "
                f"{c['final_mean_abs']:.5f} (final {c['final_abs_err']:.5f})"
                f"{'' if c['converged'] else '  [diverged]'}"
            )
    return "\n".join(lines)

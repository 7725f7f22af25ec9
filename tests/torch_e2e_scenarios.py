"""The scenarios of `uvio_tpu`'s slow end-to-end regressions, driven through
the port: the simulator -> the live manager -> estimates, ground truth and
the final calibration states, held to the reference tests' own gates.

    tests/test_sim_e2e.py            msckf, slam_vs_msckf, stereo, rep0..rep5,
                                     time_offset, extrinsic
    tests/test_integration_methods.py:144   integration_discrete, _analytical
    tests/test_imu_intrinsics.py:93, :113   imu_seeded, imu_calibrated
    tests/test_uwb.py:327            uwb

Same simulators, seeds, horizons, estimator settings and gates; each
scenario is `run(name, device)`, which raises `AssertionError` when a gate
fails and otherwise returns a record: ATE, the gate, frames, the manager's
ms per frame (`last_timing["total"]`, median) and, on a CUDA device, the
host syncs per frame of the manager's own calls on 5 frames, plus the
calibration errors where a scenario estimates calibration.

Imports only the port, numpy and scipy, so that `chip_smoke.py` (no JAX)
runs the same scenario code as `tests/test_torch_sim_e2e.py`,
`tests/test_torch_e2e_calib.py` and `tests/test_torch_e2e_cuda.py`. The
caller sets `torch.backends.cudnn.allow_tf32 = False` (the step raises
otherwise).
"""

import statistics
import warnings

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from uvio_tpu_torch.eval import ate, nees
from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager
from uvio_tpu_torch.math import quat_to_rot, rot_to_quat
from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory
from uvio_tpu_torch.types.state import dm_identity

SYNC_FRAMES = (20, 25)  # the frames whose host syncs are counted on a card


def gate(ok, what):
    if not ok:
        raise AssertionError(what)


def cam_configs(cams):
    return [CameraConfig(model=c.model, intrinsics=c.intrinsics, q_ItoC=c.q_ItoC, p_IinC=c.p_IinC)
            for c in cams]


def init_with_gt(sim, mgr, t_shift=0.0):
    g = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start - t_shift, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])


class _SyncCount:
    """Host syncs of the manager's calls, by `set_sync_debug_mode("warn")`."""

    def __init__(self, on):
        self.on, self.n = on, 0

    def __call__(self, fn, *args):
        if not self.on:
            return fn(*args)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                self.n += sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def drive(sim, mgr, done, t_shift=0.0, uwb=False, cov=False):
    """Feed `sim` into `mgr` as the reference tests do, until
    `done(frames, last_stamp)` (checked before each IMU sample) or the
    simulator ends. Frames reach the manager stamped `t - t_shift`; the
    record keeps the IMU-clock stamps. Returns the record as numpy: t, q,
    p, gt_q, gt_p, (Po, Pp with `cov`), frame_ms, syncs_per_frame."""
    rec = {k: [] for k in ("t", "q", "p", "gt_q", "gt_p", "Po", "Pp", "frame_ms")}
    counted = mgr.state.cov.device.type == "cuda"
    syncs = _SyncCount(False)
    f_cam, f_uwb = sim.params.sim_freq_cam, sim.params.uwb_freq
    while sim.ok() and not done(len(rec["t"]), rec["t"][-1] if rec["t"] else sim.t_start):
        syncs.on = counted and SYNC_FRAMES[0] <= len(rec["t"]) < SYNC_FRAMES[1]
        r = sim.get_next_imu()
        if r is None:
            break
        syncs(mgr.feed_imu, *r)
        t = r[0]
        if uwb and sim.cur_uwb_t + 1.0 / f_uwb <= t:
            ru = sim.get_next_uwb()
            if ru is not None:
                syncs(mgr.feed_uwb, *ru)
        if sim.cur_cam_t + 1.0 / f_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            tc, obs = rc
            syncs(mgr.feed_features, tc - t_shift, obs)
            rec["frame_ms"].append(mgr.last_timing["total"] * 1e3)
            q, p = mgr.get_pose()
            g = sim.get_gt_state(tc)
            for k, v in (("t", tc), ("q", q), ("p", p), ("gt_q", g["q_GtoI"]), ("gt_p", g["p_IinG"])):
                rec[k].append(v)
            if cov:
                P = mgr.state.cov[0:6, 0:6].cpu().numpy()
                rec["Po"].append(P[0:3, 0:3])
                rec["Pp"].append(P[3:6, 3:6])
    out = {k: np.asarray(v) for k, v in rec.items()}
    n_sync = SYNC_FRAMES[1] - SYNC_FRAMES[0]
    out["syncs_per_frame"] = syncs.n / n_sync if counted and len(rec["t"]) >= SYNC_FRAMES[1] else None
    return out


def after(duration, t_start):
    """The reference tests' stop: the last frame lies more than `duration`
    past the start."""
    return lambda n, t_last: n > 0 and t_last - t_start > duration


def ate_none(r):
    return ate(r["t"], r["q"], r["p"], r["t"], r["gt_q"], r["gt_p"], method="none")


def summary(*runs, **extra):
    """The record of a scenario of one or more drives (syncs: the last's)."""
    return {"frames": sum(len(r["t"]) for r in runs),
            "ms_per_frame": statistics.median(np.concatenate([r["frame_ms"] for r in runs])),
            "syncs_per_frame": runs[-1]["syncs_per_frame"], **extra}


# ---- tests/test_sim_e2e.py -------------------------------------------------

def _mono_sim(seed, duration, **params):
    return Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=50, seed=seed, **params),
                     trajectory=circle_trajectory(duration=duration))


def run_sim(device, max_slam=0, duration=12.0, seed=7):
    """`test_sim_e2e.run_sim`: mono, 11 clones, 40 MSCKF features."""
    sim = _mono_sim(seed, duration + 6.0)
    mgr = VioManager(VioConfig(max_clones=11, max_msckf_in_update=40, max_slam=max_slam,
                               sigma_pix=sim.params.sigma_pix, cameras=cam_configs(sim.params.cameras),
                               device=device))
    init_with_gt(sim, mgr)
    return drive(sim, mgr, after(duration, sim.t_start), cov=True)


def msckf(device):
    r = run_sim(device, max_slam=0)
    res = ate_none(r)
    gate(res["rmse_pos"] < 0.20, f"rmse_pos {res['rmse_pos']} >= 0.20")
    gate(res["rmse_ori_deg"] < 1.0, f"rmse_ori_deg {res['rmse_ori_deg']} >= 1.0")
    n_o, n_p = nees(r["q"], r["p"], r["Po"], r["Pp"], r["gt_q"], r["gt_p"])
    gate(np.median(n_o) < 10.0, f"median orientation NEES {np.median(n_o)} >= 10")
    gate(np.median(n_p) < 10.0, f"median position NEES {np.median(n_p)} >= 10")
    gate(np.isfinite(r["Pp"]).all(), "non-finite position covariance")
    return summary(r, ate_pos_m=res["rmse_pos"], ate_ori_deg=res["rmse_ori_deg"],
                   nees_median=[np.median(n_o), np.median(n_p)],
                   gate="ATE < 0.20 m and < 1.0 deg, median NEES < 10")


def slam_vs_msckf(device):
    r0 = run_sim(device, max_slam=0, duration=25.0)
    r1 = run_sim(device, max_slam=20, duration=25.0)
    a0, a1 = ate_none(r0)["rmse_pos"], ate_none(r1)["rmse_pos"]
    gate(a1 < a0, f"SLAM {a1} not below MSCKF-only {a0}")
    gate(a1 < 0.15, f"SLAM rmse_pos {a1} >= 0.15")
    return summary(r0, r1, ate_pos_m=a1, ate_pos_m_msckf_only=a0, ms_per_frame_slam=statistics.median(r1["frame_ms"]),
                   gate="SLAM ATE < MSCKF-only ATE and < 0.15 m")


def stereo(device, duration=10.0, seed=21):
    cams = [SimCamera(), SimCamera(p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(SimParams(seed=seed, cameras=cams), trajectory=circle_trajectory(duration=duration + 6.0))
    mgr = VioManager(VioConfig(max_clones=11, sigma_pix=1.0, cameras=cam_configs(cams), device=device))
    init_with_gt(sim, mgr)
    r = drive(sim, mgr, after(duration, sim.t_start))
    a = ate_none(r)["rmse_pos"]
    gate(a < 0.08, f"stereo rmse_pos {a} >= 0.08")
    return summary(r, ate_pos_m=a, gate="ATE < 0.08 m")


def slam_rep(device, rep):
    sim = _mono_sim(7, 14.0)
    mgr = VioManager(VioConfig(max_clones=11, max_slam=15, feat_rep_slam=rep, sigma_pix=1.0,
                               cameras=cam_configs(sim.params.cameras), device=device))
    init_with_gt(sim, mgr)
    r = drive(sim, mgr, after(8, sim.t_start))
    a = ate_none(r)["rmse_pos"]
    gate(a < 0.25, f"rep {rep} rmse_pos {a} >= 0.25")
    return summary(r, ate_pos_m=a, gate="ATE < 0.25 m")


DT_TRUE = 0.02


def _time_offset_run(device, dt_seed, calib):
    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=50, seed=11),
                    trajectory=circle_trajectory(duration=26.0, rate_mod=0.45))
    mgr = VioManager(VioConfig(max_clones=11, sigma_pix=1.0, calib_cam_timeoffset=calib, camimu_dt=dt_seed,
                               cameras=cam_configs(sim.params.cameras), device=device))
    init_with_gt(sim, mgr, t_shift=DT_TRUE)  # the estimator's clock is the camera clock
    r = drive(sim, mgr, after(18.0, sim.t_start), t_shift=DT_TRUE)
    return r, ate_none(r), float(mgr.state.calib_dt)


def time_offset(device):
    """(a) a fixed, correctly seeded offset tracks; (b) estimated from a
    10 ms seed error, the error shrinks more than 5x."""
    r_fixed, res_fixed, dt_fixed = _time_offset_run(device, DT_TRUE, calib=False)
    gate(dt_fixed == DT_TRUE, f"the fixed offset moved to {dt_fixed}")
    gate(res_fixed["rmse_pos"] < 0.20, f"fixed-offset rmse_pos {res_fixed['rmse_pos']} >= 0.20")
    r_cal, res_cal, dt_est = _time_offset_run(device, DT_TRUE - 0.010, calib=True)
    gate(abs(dt_est - DT_TRUE) < 0.010 / 5, f"calib_dt {dt_est} against {DT_TRUE}")
    gate(res_cal["rmse_pos"] < 0.25, f"calibrated rmse_pos {res_cal['rmse_pos']} >= 0.25")
    return summary(r_fixed, r_cal, ate_pos_m=res_cal["rmse_pos"], ate_pos_m_fixed_offset=res_fixed["rmse_pos"],
                   calib_err={"dt_s": abs(dt_est - DT_TRUE), "dt_s_start": 0.010},
                   gate="fixed: ATE < 0.20 m; estimated: |dt error| < 2 ms (from 10), ATE < 0.25 m")


def extrinsic(device):
    """A perturbed camera-IMU rotation converges toward the truth while the
    filter keeps tracking (201 frames)."""
    sim = Simulator(SimParams(seed=13), trajectory=circle_trajectory(duration=26.0))
    cam = sim.params.cameras[0]  # true extrinsics: identity / zero
    dR = Rotation.from_euler("xyz", [0.8, -0.6, 0.5], degrees=True).as_matrix()
    q_pert = rot_to_quat(torch.as_tensor(dR, dtype=torch.float64)).numpy()
    p_pert = np.array([0.01, -0.008, 0.012])
    mgr = VioManager(VioConfig(
        max_clones=11, sigma_pix=1.0, calib_cam_pose=True, device=device,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=q_pert, p_IinC=p_pert)]))
    init_with_gt(sim, mgr)
    r = drive(sim, mgr, lambda n, _: n > 200)
    R_est = quat_to_rot(mgr.state.calib_cam_q[0].cpu()).numpy()
    err_rot0 = np.linalg.norm(Rotation.from_matrix(dR).as_rotvec())
    err_rot1 = np.linalg.norm(Rotation.from_matrix(R_est).as_rotvec())
    gate(err_rot1 < 0.5 * err_rot0, f"rotation error {np.degrees(err_rot1)} deg from {np.degrees(err_rot0)}")
    err_pos1 = float(np.linalg.norm(mgr.state.calib_cam_p[0].cpu().numpy()))
    gate(err_pos1 < 1.5 * np.linalg.norm(p_pert), f"translation error {err_pos1} m diverges")
    return summary(r, ate_pos_m=ate_none(r)["rmse_pos"],
                   calib_err={"rot_deg": np.degrees(err_rot1), "rot_deg_start": np.degrees(err_rot0),
                              "pos_m": err_pos1, "pos_m_start": np.linalg.norm(p_pert)},
                   gate="rotation error < 0.5x its start, translation error < 1.5x its start")


# ---- tests/test_integration_methods.py:144 -----------------------------------

def integration(device, method):
    """100 frames with the `method` integrator; final position error < 0.2 m."""
    sim = Simulator(SimParams(seed=11), trajectory=circle_trajectory(duration=14.0))
    mgr = VioManager(VioConfig(max_clones=11, sigma_pix=sim.params.sigma_pix, integration=method,
                               cameras=cam_configs(sim.params.cameras), device=device))
    init_with_gt(sim, mgr)
    r = drive(sim, mgr, lambda n, _: n >= 100)
    err = float(np.linalg.norm(r["p"][-1] - r["gt_p"][-1])) if len(r["t"]) else None
    gate(err is not None and err < 0.2, f"{method}: final position error {err}")
    return summary(r, ate_pos_m=ate_none(r)["rmse_pos"], final_pos_err_m=err, gate="final position error < 0.2 m")


# ---- tests/test_imu_intrinsics.py:93, :113 -------------------------------------

TRUE_DW = np.array([1.02, 0.004, -0.003, 0.985, 0.006, 1.01])
TRUE_DA = np.array([0.99, -0.005, 0.004, 1.015, -0.006, 0.98])


def _imu_sim():
    return Simulator(SimParams(seed=5, imu_dw=TRUE_DW, imu_da=TRUE_DA), trajectory=circle_trajectory(duration=24.0))


def _imu_run(device, duration=14.0, **cfg):
    sim = _imu_sim()
    mgr = VioManager(VioConfig(max_clones=11, sigma_pix=sim.params.sigma_pix,
                               cameras=cam_configs(sim.params.cameras), device=device, **cfg))
    init_with_gt(sim, mgr)
    r = drive(sim, mgr, lambda n, t_last: t_last - sim.t_start >= duration)
    return mgr, r, np.linalg.norm(r["p"] - r["gt_p"], axis=1)


def imu_seeded(device):
    """A filter seeded with the true IMU intrinsics tracks."""
    _, r, errs = _imu_run(device, imu_dw=TRUE_DW, imu_da=TRUE_DA)
    gate(errs[-1] < 0.15, f"final position error {errs[-1]} >= 0.15")
    return summary(r, ate_pos_m=ate_none(r)["rmse_pos"], final_pos_err_m=errs[-1],
                   gate="final position error < 0.15 m")


def imu_calibrated(device):
    """Identity-seeded on a miscalibrated IMU: online calibration keeps
    tracking and moves Dw/Da toward the truth."""
    _, r_wrong, errs_wrong = _imu_run(device, duration=20.0)
    mgr, r_cal, errs_cal = _imu_run(device, duration=20.0, calib_imu_intrinsics=True,
                                    calib_imu_dw_prior=0.03, calib_imu_da_prior=0.03)
    err0_dw = np.linalg.norm(np.asarray(dm_identity(0)) - TRUE_DW)
    err1_dw = np.linalg.norm(mgr.state.calib_imu_dw.cpu().numpy() - TRUE_DW)
    err0_da = np.linalg.norm(np.asarray(dm_identity(0)) - TRUE_DA)
    err1_da = np.linalg.norm(mgr.state.calib_imu_da.cpu().numpy() - TRUE_DA)
    gate(err1_dw + err1_da < 0.6 * (err0_dw + err0_da), f"intrinsic error {err1_dw + err1_da} from {err0_dw + err0_da}")
    q = max(1, len(errs_cal) // 4)
    tail_cal, tail_wrong = np.mean(errs_cal[-q:]), np.mean(errs_wrong[-q:])
    gate(tail_cal < max(0.2, 1.1 * tail_wrong), f"calibrated tail {tail_cal} against {tail_wrong}")
    return summary(r_wrong, r_cal, ate_pos_m=ate_none(r_cal)["rmse_pos"],
                   ate_pos_m_uncalibrated=ate_none(r_wrong)["rmse_pos"], tail_pos_err_m=tail_cal,
                   tail_pos_err_m_uncalibrated=tail_wrong,
                   calib_err={"dw_da": err1_dw + err1_da, "dw_da_start": err0_dw + err0_da},
                   gate="Dw+Da error < 0.6x its start; tail error < max(0.2, 1.1x uncalibrated)")


# ---- tests/test_uwb.py:327 ----------------------------------------------------------

def uwb(device, duration=10.0, seed=7):
    """4 biased anchors with imperfect priors, 15 SLAM slots, float64."""
    from uvio_tpu_torch.uwb_manager import AnchorConfig, UVioConfig, UVioManager

    uwb_anchors = {
        1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
        2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
        3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
        4: (np.array([4.0, -4.0, 1.0]), 0.0, 0.02),
    }
    sim = _mono_sim(seed, duration + 6.0, uwb_anchors=uwb_anchors)
    rng = np.random.default_rng(1)
    anchors = [AnchorConfig(anchor_id=aid, p_AinG=p + rng.normal(scale=0.05, size=3),
                            prior_cov=np.diag([0.05**2] * 3 + [0.25**2, 0.025**2]))
               for aid, (p, g, a) in uwb_anchors.items()]
    mgr = UVioManager(UVioConfig(max_clones=11, max_msckf_in_update=40, max_slam=15, sigma_pix=sim.params.sigma_pix,
                                 cameras=cam_configs(sim.params.cameras), max_anchors=4, anchors=anchors,
                                 sigma_range=sim.params.sigma_range, dtype="float64", device=device))
    init_with_gt(sim, mgr)
    r = drive(sim, mgr, after(duration, sim.t_start), uwb=True)
    res = ate_none(r)
    gate(res["rmse_pos"] < 0.12, f"rmse_pos {res['rmse_pos']} >= 0.12")
    gate(res["rmse_ori_deg"] < 1.2, f"rmse_ori_deg {res['rmse_ori_deg']} >= 1.2")
    return summary(r, ate_pos_m=res["rmse_pos"], ate_ori_deg=res["rmse_ori_deg"], gate="ATE < 0.12 m and < 1.2 deg")


# longest first (a worker pool then ends soonest): CPU seconds in one thread
# run from ~100 (imu_calibrated, 400 frames) down to ~12 (a representation)
SCENARIOS = {
    "imu_calibrated": imu_calibrated,
    "slam_vs_msckf": slam_vs_msckf,
    "time_offset": time_offset,
    "extrinsic": extrinsic,
    "imu_seeded": imu_seeded,
    "stereo": stereo,
    "integration_analytical": lambda device: integration(device, "analytical"),
    "integration_discrete": lambda device: integration(device, "discrete"),
    "uwb": uwb,
    "msckf": msckf,
    **{f"rep{k}": (lambda device, k=k: slam_rep(device, k)) for k in range(6)},
}


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return float(v) if isinstance(v, np.floating) else v


def run(name, device):
    """Scenario `name` on `device`; its record (module docstring), of
    plain Python numbers."""
    return _plain({"case": name, **SCENARIOS[name](device)})

"""Capture real per-frame FrameBundles from a simulated host loop.

Port of `uvio_tpu/eval/capture.py`: runs the UVioManager host loop on a
seeded B-spline simulator (EuRoC default noise, biased UWB anchors, SLAM
landmarks) and records the exact padded bundles the host hands to the
device step, plus the state at the end of a warm-up prefix. This gives
benchmarks realistic inputs: chi2 gates see real residuals, SLAM slots
fill and re-anchor, UWB ranges accept and reject.

`bench_scenario`, `drive` and `record_live` are the scenario, the feeding
loop and the recording hook on their own, for callers that keep the
manager (the smoke run holds the live loop's decisions against the
committed fixture and times it with them).
"""

from __future__ import annotations

import numpy as np

from ..manager import CameraConfig
from ..sim import SimParams, Simulator, circle_trajectory
from ..types.state import state_to_numpy
from ..uwb_manager import AnchorConfig, UVioConfig, UVioManager

# id -> (p_AinG, gamma, alpha): four anchors with constant and
# distance-proportional range biases
UWB_ANCHORS = {
    1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
    2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
    3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
    4: (np.array([4.0, -4.0, 1.0]), 0.0, 0.02),
}


def bench_scenario(n_frames: int, seed: int = 7, max_slam: int = 25, dtype: str = "float32",
                   device=None, fused_step: bool = True):
    """(sim, mgr): the benchmark's simulator (200 Hz IMU, 10 Hz camera,
    20 Hz UWB, a circle long enough for `n_frames`) and a UVioManager on
    `device` (None: the card) initialized at the simulator's first state;
    `fused_step=False` gives the staged manager."""
    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=60, seed=seed,
                  uwb_anchors=UWB_ANCHORS),
        trajectory=circle_trajectory(duration=n_frames / 10.0 + 8.0),
    )
    cam = sim.params.cameras[0]
    rng = np.random.default_rng(1)
    anchor_cfgs = [
        AnchorConfig(
            anchor_id=aid,
            p_AinG=p + rng.normal(scale=0.05, size=3),
            prior_cov=np.diag([0.05**2] * 3 + [0.25**2, 0.025**2]),
        )
        for aid, (p, g, a) in UWB_ANCHORS.items()
    ]
    cfg = UVioConfig(
        max_clones=11,
        max_msckf_in_update=40,
        max_slam=max_slam,
        sigma_pix=sim.params.sigma_pix,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC,
                              p_IinC=cam.p_IinC)],
        max_anchors=len(anchor_cfgs),
        anchors=anchor_cfgs,
        sigma_range=sim.params.sigma_range,
        dtype=dtype,
        device=device,
        fused_step=fused_step,
    )
    mgr = UVioManager(cfg)
    gt0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, gt0["q_GtoI"], gt0["p_IinG"], gt0["v_IinG"], gt0["bg"], gt0["ba"])
    return sim, mgr


def drive(sim, mgr, n_frames: int, on_frame=None) -> int:
    """Feed `mgr` from `sim` (IMU, then a due range set, then a due camera
    frame) until `n_frames` camera frames went in; `on_frame(k, t)` runs
    after frame k. `mgr` may be None to advance the simulator alone.
    Returns the number of frames fed."""
    frames = 0
    while sim.ok() and frames < n_frames:
        r = sim.get_next_imu()
        if r is None:
            break
        t = r[0]
        if mgr is not None:
            mgr.feed_imu(*r)
        if sim.cur_uwb_t + 1.0 / sim.params.uwb_freq <= t:
            ru = sim.get_next_uwb()
            if ru is not None and mgr is not None:
                mgr.feed_uwb(*ru)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            if mgr is not None:
                mgr.feed_features(*rc)
            if on_frame is not None:
                on_frame(frames, rc[0])
            frames += 1
    return frames


def record_live(sim, mgr, n_frames: int, snapshot_at: int = None, on_frame=None) -> dict:
    """Drive `mgr` for `n_frames` camera frames and record, per step it
    dispatched: the numpy bundle (`bundles`), the step's infos and the
    position after it (`infos`, `p`: device tensors, so recording waits
    for nothing) and, per frame fed, a copy of `last_timing` (`timings`;
    None while the manager is not initialized). `snapshot` is the state
    before step number `snapshot_at`, as numpy; `on_frame(k, t)` runs after
    frame k as in `drive`."""
    rec = dict(bundles=[], infos=[], p=[], timings=[], snapshot=None)
    orig = mgr._jit_full

    def hook(state, fields):
        if len(rec["bundles"]) == snapshot_at:
            rec["snapshot"] = state_to_numpy(state)
        rec["bundles"].append(fields)
        new_state, infos = orig(state, fields)
        rec["infos"].append(infos)
        rec["p"].append(new_state.p)
        return new_state, infos

    def after(k, t):
        rec["timings"].append(dict(mgr.last_timing) if mgr.last_timing else None)
        if on_frame is not None:
            on_frame(k, t)

    mgr._jit_full = hook
    try:
        drive(sim, mgr, n_frames, on_frame=after)
    finally:
        mgr._jit_full = orig
    return rec


def capture_sim_bundles(n_warm: int = 20, n_bench: int = 100, seed: int = 7, max_slam: int = 25,
                        dtype: str = "float32", device=None):
    """Returns (full_cfg, state0, bundles): the manager's FullStepConfig,
    the state after `n_warm` frames as numpy arrays keyed by field, and
    the next `n_bench` bundles as numpy arrays keyed by `FrameBundle`
    field. Runs on `device` (None: the card)."""
    sim, mgr = bench_scenario(n_warm + n_bench, seed, max_slam, dtype, device)
    rec = record_live(sim, mgr, n_warm + n_bench, snapshot_at=n_warm)
    return mgr._full_cfg, rec["snapshot"], rec["bundles"][n_warm : n_warm + n_bench]

"""Port parity, the live host loop: `uvio_tpu_torch.manager.VioManager`
against `uvio_tpu.manager.VioManager`, float64 on the CPU, both fed the
same seeded numpy streams (one simulator run, recorded as events).

Tolerances: every bundle the two managers hand to their step carries the
same masks and indices and the same floats to 1e-9 (they are built from
the same numpy inputs; only the IMU window ends depend on the state, and
through host mirrors that are equal); the state agrees to 1e-8 after
every frame (the steps' own parity, `test_torch_pipeline.py`); the host
mirrors (`slot_times`, `slam_slot_by_fid`, `_time_host`) are equal, and
`_time_host` equals the device state's time after every kind of frame.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from uvio_tpu.manager import CameraConfig as JCam
from uvio_tpu.manager import VioConfig as JVioConfig
from uvio_tpu.manager import VioManager as JVioManager

from uvio_tpu_torch.manager import CameraConfig as TCam
from uvio_tpu_torch.manager import CovarianceError, VioConfig, VioManager
from uvio_tpu_torch.pipeline import FrameBundle
from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory
from uvio_tpu_torch.types.state import FIELDS, state_to_numpy

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False  # the step insists on full-float32 products

SMALL = dict(max_clones=5, max_msckf_in_update=16, max_imu_batch=32)


# ---- helpers, shared with the other manager test files ----------------

def sim_events(n_frames, seed=3, uwb_anchors=None, num_pts=40, params=None, **traj):
    """(sim, events): one run of the port's simulator (200 Hz IMU, 10 Hz
    camera, 20 Hz UWB when anchors are given; `params` holds more
    `SimParams` fields) as a list of
    ("imu", t, w, a) | ("uwb", t, ranges) | ("cam", t, obs)."""
    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=num_pts, seed=seed,
                  uwb_anchors=uwb_anchors or {}, **(params or {})),
        trajectory=circle_trajectory(duration=n_frames / 10.0 + 3.0, **traj),
    )
    events, frames = [], 0
    while frames < n_frames:
        t, w, a = sim.get_next_imu()
        events.append(("imu", t, w, a))
        if uwb_anchors and sim.cur_uwb_t + 1.0 / sim.params.uwb_freq <= t:
            events.append(("uwb", *sim.get_next_uwb()))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            events.append(("cam", *sim.get_next_cam()))
            frames += 1
    return sim, events


def sim_cameras(sim, Cam):
    return [Cam(model=c.model, intrinsics=c.intrinsics, q_ItoC=c.q_ItoC, p_IinC=c.p_IinC)
            for c in sim.params.cameras]


def init_at_start(sim, *mgrs):
    g = sim.get_gt_state(sim.t_start)
    for m in mgrs:
        m.initialize_with_gt(sim.t_start, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])


def assert_bundles_equal(got, ref, frame, atol=1e-9):
    for name in FrameBundle._fields:
        a = np.asarray(got[name])
        b = np.asarray(ref[name] if isinstance(ref, dict) else getattr(ref, name))
        assert a.shape == b.shape, (frame, name, a.shape, b.shape)
        if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {frame} {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"frame {frame} {name}")


def assert_states_close(jstate, tstate, where, atol=1e-8):
    back = state_to_numpy(tstate)
    for n in FIELDS:
        b = np.asarray(getattr(jstate, n))
        if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(back[n], b, err_msg=f"{where} {n}")
        else:
            np.testing.assert_allclose(back[n], b, rtol=0, atol=atol, err_msg=f"{where} {n}")


class Pair:
    """A `uvio_tpu` manager and the port's, fed together; records the
    bundles each hands to its fused step (staged managers hand none) and
    compares everything after a frame; `ji`, `ti` keep the infos of every
    fused step."""

    def __init__(self, jmgr, tmgr):
        self.j, self.t = jmgr, tmgr
        self.jb, self.tb = [], []
        self.ji, self.ti = [], []
        self.zupt_accepts = []
        self.checked = 0
        if not tmgr.cfg.fused_step:
            return
        j_full, t_full = jmgr._jit_full, tmgr._jit_full

        def j_hook(state, fb):
            self.jb.append(fb)
            out = j_full(state, fb)
            self.ji.append(out[1])
            return out

        def t_hook(state, fields):
            self.tb.append(fields)
            out = t_full(state, fields)
            self.ti.append(out[1])
            self.zupt_accepts.append(bool(out[1]["zupt_accepted"]))
            return out

        jmgr._jit_full, tmgr._jit_full = j_hook, t_hook

    def feed(self, ev, check=True):
        kind, args = ev[0], ev[1:]
        for m in (self.j, self.t):
            if kind == "imu":
                m.feed_imu(*args)
            elif kind == "uwb":
                m.feed_uwb(*args)
            else:
                m.feed_features(*args)
        if kind == "cam" and check:
            self.check(f"frame at t={args[0]:.2f}")

    def check(self, where):
        j, t = self.j, self.t
        assert len(self.jb) == len(self.tb), where
        for k in range(self.checked, len(self.tb)):
            assert_bundles_equal(self.tb[k], self.jb[k], f"{where} (bundle {k})")
        self.checked = len(self.tb)
        assert t.is_initialized == j.is_initialized, where
        assert_states_close(j.state, t.state, where)
        assert t.slot_times == j.slot_times and t._head == j._head, where
        assert t.slam_slot_by_fid == j.slam_slot_by_fid, where
        assert t.slam_fail == j.slam_fail and t.slam_consumed_t == j.slam_consumed_t, where
        if t.cfg.calib_cam_timeoffset:  # the interval depends on the estimated offset
            np.testing.assert_allclose(t._last_prop_dt, j._last_prop_dt, rtol=0, atol=1e-12, err_msg=where)
        else:
            assert t._last_prop_dt == j._last_prop_dt
        np.testing.assert_allclose(t._dt_host, j._dt_host, rtol=0, atol=1e-10)
        np.testing.assert_allclose(t.distance, j.distance, rtol=0, atol=1e-8)
        assert sorted(t.db.features) == sorted(j.db.features), where
        if t.is_initialized:
            assert t._time_host == j._time_host == float(t.state.time) == float(j.state.time), where

    def run(self, events, **kw):
        for ev in events:
            self.feed(ev, **kw)
        return self


def make_pair(sim, jcls=JVioManager, tcls=VioManager, jconfig=JVioConfig, tconfig=VioConfig,
              jextra=None, textra=None, **cfg):
    """Both managers on the same configuration (`jextra`/`textra` hold the
    fields whose values are objects of each package, the simulator's
    cameras unless they name others)."""
    j = jcls(jconfig(sigma_pix=sim.params.sigma_pix,
                     **{"cameras": sim_cameras(sim, JCam), **SMALL, **cfg, **(jextra or {})}))
    t = tcls(tconfig(sigma_pix=sim.params.sigma_pix, device="cpu",
                     **{"cameras": sim_cameras(sim, TCam), **SMALL, **cfg, **(textra or {})}))
    return Pair(j, t)


# ---- database ----------------------------------------------------------

def test_database_copy_behaves_as_the_original():
    from uvio_tpu.frontend.database import FeatureDatabase as JDB
    from uvio_tpu.frontend.database import _tkey as j_tkey

    from uvio_tpu_torch.frontend.database import FeatureDatabase as TDB
    from uvio_tpu_torch.frontend.database import _tkey

    rng = np.random.default_rng(0)
    dbs = (JDB(), TDB())
    ids = lambda feats: [f.feat_id for f in feats]
    for step in range(60):
        t = 10.0 + 0.1 * step
        assert _tkey(t) == j_tkey(t) and isinstance(_tkey(t), int)
        for fid in rng.choice(40, size=15, replace=False):
            u, v, cam = rng.uniform(0, 700), rng.uniform(0, 400), int(rng.integers(2))
            for db in dbs:
                db.update_feature(int(fid), t, cam, u, v)
        t_q = 10.0 + 0.1 * int(rng.integers(max(step - 6, 0), step + 1))
        assert ids(dbs[0].features_seen_at(t_q)) == ids(dbs[1].features_seen_at(t_q + 2e-10))
        assert ids(dbs[0].features_not_seen_at(t)) == ids(dbs[1].features_not_seen_at(t))
        if step % 3 == 2:
            for db in dbs:
                for f in db.features_not_seen_at(t)[:4]:
                    f.to_delete = True
                db.cleanup()
        if step % 5 == 4:
            for db in dbs:
                db.cleanup_older_than(t - 0.35 + 1e-9)
        assert dbs[0].to_dict() == dbs[1].to_dict() and len(dbs[0]) == len(dbs[1])
        assert dbs[0]._by_time == dbs[1]._by_time
    back = TDB.from_dict(dbs[0].to_dict())
    assert back.to_dict() == dbs[1].to_dict()
    assert ids(back.features_seen_at(t)) == ids(dbs[1].features_seen_at(t))


# ---- constructor -------------------------------------------------------

ALL_CALIB = dict(calib_cam_pose=True, calib_cam_intrinsics=True, calib_cam_timeoffset=True,
                 calib_imu_intrinsics=True, camimu_dt=0.02)


@pytest.mark.parametrize("flags", [
    {}, dict(calib_cam_pose=True), dict(calib_cam_intrinsics=True), dict(calib_cam_timeoffset=True, camimu_dt=-0.01),
    dict(calib_imu_intrinsics=True), dict(calib_imu_intrinsics=True, calib_imu_g_sensitivity=True, imu_model=1),
    dict(ALL_CALIB, calib_imu_g_sensitivity=True, max_slam=4),
], ids=lambda f: "+".join(k for k, v in f.items() if v is True) or "none")
def test_constructor_seeds_and_priors_match(flags):
    rng = np.random.default_rng(5)
    seeds = dict(imu_dw=np.array([1.01, 0.002, -0.001, 0.99, 0.003, 1.02]), imu_da=rng.normal(size=6) * 0.01 + 1,
                 imu_tg=rng.normal(size=9) * 1e-3, imu_gq=np.array([0.01, -0.02, 0.005, 1.0]) / np.linalg.norm([0.01, -0.02, 0.005, 1.0]))
    cams = lambda C: [C(), C(intrinsics=np.array([457.0, 456.0, 379.0, 255.0, -0.28, 0.07, 2e-4, 2e-5]),
                            p_IinC=np.array([-0.11, 0.0, 0.0]))]
    j = JVioManager(JVioConfig(cameras=cams(JCam), **SMALL, **flags, **seeds))
    t = VioManager(VioConfig(cameras=cams(TCam), device="cpu", **SMALL, **flags, **seeds))
    assert dataclasses.asdict(t.layout) == dataclasses.asdict(j.layout)
    assert_states_close(j.state, t.state, "constructed", atol=1e-12)
    assert t._dt_host == j._dt_host and t.integration == "rk4"
    L = t.layout
    for on, off in ((L.calib_imu_intrinsics, L.imu_intr_off), (L.calib_cam_timeoffset, L.calib_dt_off),
                    (L.calib_cam_pose, L.calib_cam_pose_off + 6), (L.calib_cam_intrinsics, L.calib_cam_intr_off + 8)):
        if on:
            assert float(t.state.cov[off, off]) > 0


@pytest.mark.parametrize("flag", [dict(use_dynamic_init=True), dict(fused_step=False)], ids=lambda f: next(iter(f)))
def test_unported_paths_raise(flag):
    """Both paths that raised here before they were ported now build: the
    in-motion initializer, and the staged path (its stages, and no fused
    step)."""
    mgr = VioManager(VioConfig(device="cpu", **flag))
    if "use_dynamic_init" in flag:
        assert mgr.cfg.use_dynamic_init
        return
    assert not hasattr(mgr, "_jit_full") and callable(mgr._stage_msckf) and callable(mgr._stage_prop)


def test_device_none_is_the_card_or_an_error():
    if torch.cuda.is_available():
        assert VioManager(VioConfig()).state.cov.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VioManager(VioConfig())


# ---- 30 frames, MSCKF only and with SLAM ----------------------------------

@pytest.fixture(scope="module")
def mono_run():
    """30 frames of mono MSCKF through both managers, checked per frame;
    the IMU-rate pose is read between frames 20 and 21."""
    sim, events = sim_events(30, seed=3)
    pair = make_pair(sim)
    init_at_start(sim, pair.j, pair.t)
    n_cam = 0
    poses = None
    for ev in events:
        pair.feed(ev)
        n_cam += ev[0] == "cam"
        if n_cam == 20 and ev[0] == "imu" and poses is None and ev[1] > pair.t._time_host + 0.03:
            poses = (pair.j.get_propagated_pose(ev[1]), pair.t.get_propagated_pose(ev[1]))
    return sim, events, pair, poses


def test_mono_msckf_run_matches(mono_run):
    sim, _, pair, _ = mono_run
    assert len(pair.tb) == 30 and pair.checked == 30
    assert sum(int(b["marg_enable"]) for b in pair.tb) == 25  # the ring is full from frame 5 on
    assert sum(b["msckf_mask"].any() for b in pair.tb) >= 20
    err = np.linalg.norm(pair.t.get_pose()[1] - sim.get_gt_state(pair.t._time_host)["p_IinG"])
    assert err < 0.2
    for k in ("uwb", "propagation", "marginalization", "total"):
        assert pair.t.last_timing[k] >= 0.0
    assert pair.t.last_timing["timestamp"] == pair.t._time_host


def test_propagated_pose_and_active_tracks_match(mono_run):
    _, _, pair, poses = mono_run
    for a, b in zip(*poses):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-8)
    assert np.abs(poses[1][1] - pair.t.get_pose()[1]).max() > 1e-3  # it did move ahead of the frame's pose
    (jid, jp), (tid, tp) = pair.j.get_active_tracks(), pair.t.get_active_tracks()
    np.testing.assert_array_equal(tid, np.asarray(jid))
    assert len(tid) >= 5
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-8)
    # before its time the pose is the state's
    np.testing.assert_array_equal(pair.t.get_propagated_pose(pair.t._time_host - 1.0)[1], pair.t.get_pose()[1])


def test_out_of_order_image_is_dropped_with_a_warning(mono_run, capsys):
    sim, events, _, _ = mono_run
    mgr = VioManager(VioConfig(sigma_pix=sim.params.sigma_pix, cameras=sim_cameras(sim, TCam),
                               device="cpu", **SMALL))
    init_at_start(sim, mgr)
    cams = [ev for ev in events if ev[0] == "cam"]
    for ev in events[: events.index(cams[1]) + 1]:
        (mgr.feed_imu if ev[0] == "imu" else mgr.feed_features)(*ev[1:])
    before, t_before = state_to_numpy(mgr.state), mgr._time_host
    assert t_before == cams[1][1]
    mgr.feed_features(*cams[0][1:])  # the first frame again, after the second
    assert "dropped" in capsys.readouterr().err
    after = state_to_numpy(mgr.state)
    assert all(np.array_equal(before[k], after[k]) for k in FIELDS)
    assert mgr._time_host == t_before and len(mgr.slot_times) == 2


def test_async_dispatch_gives_the_sync_state(mono_run):
    """The async path reads nothing back on 31 of 32 frames and leaves the
    same state, mirrors and database as the sync path (1e-9)."""
    sim, events, pair, _ = mono_run
    mgr = VioManager(VioConfig(sigma_pix=sim.params.sigma_pix, cameras=sim_cameras(sim, TCam),
                               device="cpu", async_dispatch=True, **SMALL))
    init_at_start(sim, mgr)
    fetches = []
    fetch = mgr._fetch
    mgr._fetch = lambda infos: fetches.append(mgr._time_host) or fetch(infos)
    events = [ev for ev in events if ev[0] != "cam" or ev[1] <= pair.t._time_host]  # as far as the pair went
    for ev in events + sim_more(sim, 4):
        (mgr.feed_imu if ev[0] == "imu" else mgr.feed_features)(*ev[1:])
        if ev[0] == "cam" and len(fetches) == 0 and abs(ev[1] - pair.t._time_host) < 1e-9:
            a, b = state_to_numpy(pair.t.state), state_to_numpy(mgr.state)
            for n in FIELDS:
                np.testing.assert_allclose(b[n], a[n], rtol=0, atol=1e-9, err_msg=n)
            assert mgr.slot_times == pair.t.slot_times and mgr._time_host == pair.t._time_host
            assert sorted(mgr.db.features) == sorted(pair.t.db.features)
            assert mgr.distance == 0.0  # not tracked between the deferred checks
    assert len(fetches) == 1  # 34 frames: the 32nd read back, no other
    assert mgr.distance == 0.0 and mgr._last_update_p is not None
    assert mgr._time_host == float(mgr.state.time)


def sim_more(sim, n_frames):
    """`n_frames` more camera frames of events from a simulator that
    `sim_events` left mid-run (no UWB)."""
    events, frames = [], 0
    while frames < n_frames:
        t, w, a = sim.get_next_imu()
        events.append(("imu", t, w, a))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            events.append(("cam", *sim.get_next_cam()))
            frames += 1
    return events


def test_slam_run_matches():
    """30 frames with 8 SLAM slots: landmarks are initialized from frame
    ~10 on, re-observed, re-anchored and freed, identically."""
    sim, events = sim_events(30, seed=4)
    pair = make_pair(sim, max_slam=8, dt_slam_delay=0.8, max_slam_init_per_frame=4)
    init_at_start(sim, pair.j, pair.t)
    pair.run(events)
    assert pair.checked == 30
    assert sum((b["cand_ids"] >= 0).any() for b in pair.tb) >= 2
    assert sum(b["slam_mask"].any() for b in pair.tb) >= 10
    assert len(pair.t.slam_slot_by_fid) >= 4
    (jid, jp), (tid, tp) = pair.j.get_active_tracks(), pair.t.get_active_tracks()
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-8)
    assert set(pair.t.slam_slot_by_fid) <= set(tid.tolist())


# ---- initialization and ZUPT -------------------------------------------------

def _init_options():
    from uvio_tpu.init.static_init import StaticInitOptions as JOpts

    from uvio_tpu_torch.init.static_init import StaticInitOptions as TOpts

    kw = dict(window_time=1.0, imu_thresh=0.1)  # still: ~0.05, motion onset: ~0.15-0.19
    return dict(init_options=JOpts(**kw)), dict(init_options=TOpts(**kw))


def test_static_init_on_a_jerk_matches():
    """Still, then motion: both managers initialize at the same frame with
    the same stamp, replay the frames seen since through propagate+clone,
    and hold the same state (1e-9) and `init_replay_rows`."""
    sim, events = sim_events(32, seed=6, still_time=1.6)
    jx, tx = _init_options()
    pair = make_pair(sim, use_static_init=True, max_imu_batch=64, jextra=jx, textra=tx)
    fired = None
    for ev in events:
        pair.feed(ev, check=False)
        if ev[0] == "cam":
            assert pair.t.is_initialized == pair.j.is_initialized, ev[1]
            if pair.t.is_initialized:
                fired = ev[1]
                break
    assert fired is not None and not pair.tb, "initialization must fire, before any fused frame"
    assert pair.t._startup_time == pair.j._startup_time < fired
    assert_states_close(pair.j.state, pair.t.state, "after static init", atol=1e-9)
    assert len(pair.t.init_replay_rows) == len(pair.j.init_replay_rows) >= 2
    for (t1, q1, p1), (t2, q2, p2) in zip(pair.j.init_replay_rows, pair.t.init_replay_rows):
        assert t1 == t2
        np.testing.assert_allclose(q2, np.asarray(q1), rtol=0, atol=1e-9)
        np.testing.assert_allclose(p2, np.asarray(p1), rtol=0, atol=1e-9)
    assert pair.t.slot_times == pair.j.slot_times and len(pair.t.slot_times) >= 1
    assert pair.t._time_host == pair.j._time_host == float(pair.t.state.time)  # after the replay


def test_static_init_then_zupt_matches():
    """A still first 2.3 s with static init and ZUPT on: init fires without
    a jerk, every other still frame is accepted as a zero-velocity update
    (the clone ring is rolled back on each; an accepted frame drops its
    tracks, so the next has no disparity to gate on), then motion starts
    and the visual update runs. Same decisions, bundles and states
    throughout."""
    sim, events = sim_events(36, seed=6, still_time=2.3)
    jx, tx = _init_options()
    pair = make_pair(sim, use_static_init=True, try_zupt=True, zupt_max_disparity=3.0, max_imu_batch=64,
                     jextra=jx, textra=tx)
    slots_before = None
    rolled_back = 0
    for ev in events:
        if ev[0] == "cam" and pair.t.is_initialized:
            slots_before = dict(pair.t.slot_times)
        pair.feed(ev)
        if ev[0] == "cam" and pair.zupt_accepts and pair.zupt_accepts[-1] and slots_before is not None:
            assert pair.t.slot_times == slots_before  # rolled back: no clone on a frozen frame
            assert pair.t._time_host == ev[1] == float(pair.t.state.time)
            rolled_back += 1
            slots_before = None
    assert pair.t.is_initialized and pair.checked == len(pair.tb) >= 10
    assert sum(int(b["zupt_try"]) for b in pair.tb) >= 2
    assert rolled_back >= 2 and not all(pair.zupt_accepts)
    assert pair.t._has_moved and getattr(pair.j, "_has_moved", False)
    assert any(int(b["marg_enable"]) for b in pair.tb)


# ---- covariance health ---------------------------------------------------------

@pytest.mark.parametrize("policy", ["raise", "warn", "ignore"])
def test_on_cov_fail(mono_run, policy):
    sim, events, _, _ = mono_run
    mgr = VioManager(VioConfig(sigma_pix=sim.params.sigma_pix, cameras=sim_cameras(sim, TCam),
                               device="cpu", on_cov_fail=policy, **SMALL))
    init_at_start(sim, mgr)
    full = mgr._jit_full

    def broken(state, fields):
        state, infos = full(state, fields)
        return state, {**infos, "cov_ok": torch.zeros((), dtype=torch.bool)}

    mgr._jit_full = broken
    first_frame = next(i for i, ev in enumerate(events) if ev[0] == "cam")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for ev in events[:first_frame]:
            mgr.feed_imu(*ev[1:])
        if policy == "raise":
            with pytest.raises(CovarianceError, match="fused frame step"):
                mgr.feed_features(*events[first_frame][1:])
        else:
            mgr.feed_features(*events[first_frame][1:])
            assert mgr._time_host == events[first_frame][1]
    assert [w.category for w in caught if issubclass(w.category, RuntimeWarning)] == (
        [RuntimeWarning] if policy == "warn" else [])

"""Port parity, `uvio_tpu_torch.uwb_manager.UVioManager` against
`uvio_tpu.uwb_manager.UVioManager`: the counterparts of the UVIO manager
tests of `tests/test_uwb.py` (drain and gates, base configuration kept,
runtime anchors, float32 anchors through fused frames), each also held
against the JAX manager's state, and the live loop with UWB including the
overflow drain. float64 on the CPU unless said; states agree to 1e-8,
constructed states to 1e-12, bundles as in `test_torch_manager.py`."""

import numpy as np
import pytest
import torch

from test_torch_manager import (
    JCam,
    SMALL,
    TCam,
    assert_states_close,
    init_at_start,
    make_pair,
    sim_cameras,
    sim_events,
)

from uvio_tpu.uwb_manager import AnchorConfig as JAnchor
from uvio_tpu.uwb_manager import UVioConfig as JUVioConfig
from uvio_tpu.uwb_manager import UVioManager as JUVioManager

from uvio_tpu_torch.uwb_manager import AnchorConfig, UVioConfig, UVioManager

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

ANCHORS = {
    1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
    2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
    3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
    4: (np.array([4.0, -4.0, 1.0]), 0.0, 0.02),
}


def _both(jkw, tkw, **cfg):
    return (JUVioManager(JUVioConfig(cameras=[JCam()], **cfg, **jkw)),
            UVioManager(UVioConfig(cameras=[TCam()], device="cpu", **cfg, **tkw)))


def test_uvio_manager_drain_and_gates(capsys):
    mk = lambda A: [A(anchor_id=10, p_AinG=np.array([3.0, 0, 1.5])),
                    A(anchor_id=11, p_AinG=np.array([-2.0, 2, 0.5]), fix=True)]
    j, t = _both(dict(anchors=mk(JAnchor)), dict(anchors=mk(AnchorConfig)),
                 max_clones=5, max_anchors=4, sigma_range=0.05)
    assert t.anchors_initialized and t.anchor_slot_by_id == j.anchor_slot_by_id
    off = t.layout.anchor_slot_off(t.anchor_slot_by_id[11])
    P = t.state.cov.numpy()
    np.testing.assert_array_equal(P[off : off + 5, off : off + 5], 0.0)  # a fixed anchor has no covariance
    off0 = t.layout.anchor_slot_off(t.anchor_slot_by_id[10])
    assert P[off0, off0] > 0
    assert_states_close(j.state, t.state, "constructed", atol=1e-12)

    d10 = np.linalg.norm([3.0, 0, 1.5])
    for m in (j, t):
        m.feed_uwb(0.04, {10: d10})  # before initialization: dropped
        assert len(m.uwb_buffer) == 0
        m.initialize_with_gt(0.0, np.array([0, 0, 0, 1.0]), np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3))
        for i in range(30):
            m.feed_imu(0.005 * (i + 1), np.zeros(3), np.array([0, 0, 9.81]))
        # traveled-distance gate (UVioManager.cpp:64-67): ranges arriving
        # before the platform has moved past min_dist_to_use_uwb are dropped
        m.feed_uwb(0.04, {10: d10})
        assert len(m.uwb_buffer) == 0
        m.distance = 0.01  # pretend we've moved
        m.feed_uwb(0.05, {10: d10 + 0.01, 99: 5.0})  # unknown anchor dropped
        assert len(m.uwb_buffer) == 1 and 99 not in m.uwb_buffer[0][1]
        m.feed_uwb(0.06, {99: 5.0})  # nothing known in the set: not buffered, not a stamp
        assert len(m.uwb_buffer) == 1 and m._last_uwb_t == 0.05
        m.feed_uwb(0.1, {11: 2.9})  # at the image time: waits for the next frame
        m._pre_visual_update(0.1)  # the drain happens before the visual update
        assert [s[0] for s in m.uwb_buffer] == [0.1]
        assert m._time_host == 0.05 == float(m.state.time)
        m.feed_uwb(0.02, {10: d10})  # out of order: dropped with a warning
        assert len(m.uwb_buffer) == 1
    assert capsys.readouterr().err.count("out of order") == 2
    assert bool(t.last_uwb_info["accepted"][t.anchor_slot_by_id[10]])
    assert_states_close(j.state, t.state, "after the drain")


def test_uvio_manager_preserves_base_config():
    """The UVIO subclass keeps every base option (SLAM representation, IMU
    intrinsics, the dt seed, calibration priors, the integration method)
    beside the UWB extras."""
    cfg = dict(max_clones=5, max_slam=10, feat_rep_slam=1, calib_cam_timeoffset=True, camimu_dt=0.03,
               calib_cam_pose=True, calib_imu_intrinsics=True, integration="discrete", max_anchors=4,
               calib_uwb_extrinsics=True, p_IinU=np.array([0.05, -0.02, 0.1]))
    mk = lambda A: [A(anchor_id=7, p_AinG=np.array([1.0, 2.0, 0.5]))]
    j, t = _both(dict(anchors=mk(JAnchor)), dict(anchors=mk(AnchorConfig)), **cfg)
    L = t.layout
    assert L.slam_rep == 1 and L.max_slam == 10 and L.calib_imu_intrinsics
    assert L.calib_cam_timeoffset and L.calib_cam_pose and L.max_anchors == 4 and L.calib_uwb_extrinsics
    assert float(t.state.calib_dt) == 0.03 == t._dt_host
    np.testing.assert_array_equal(t.state.uwb_p_IinU.numpy(), [0.05, -0.02, 0.1])
    P = t.state.cov.numpy()
    for off in (L.calib_dt_off, L.calib_cam_pose_off, L.imu_intr_off, L.calib_uwb_off,
                L.anchor_slot_off(t.anchor_slot_by_id[7])):
        assert P[off, off] > 0
    # the integration method reaches the step and both host-side propagators
    assert t.integration == "discrete" == t._full_cfg.integration
    assert_states_close(j.state, t.state, "constructed", atol=1e-12)
    # and a propagation with the intrinsic error states runs, as in uvio_tpu
    for m in (j, t):
        m.initialize_with_gt(0.0, np.array([0, 0, 0, 1.0]), np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3))
        for i in range(30):
            m.feed_imu(0.005 * (i + 1), np.array([0.01, 0.02, -0.01]), np.array([0.1, 0, 9.81]))
        m._propagate_clone(0.1)
    assert_states_close(j.state, t.state, "after propagate+clone", atol=1e-10)
    assert t._time_host == 0.1 == float(t.state.time)


def test_runtime_anchor_initialization():
    """Anchors arriving at runtime: best-determinant fixed, others
    estimated; late additions supported."""
    j, t = _both({}, {}, max_clones=4, max_anchors=6)
    for m, A in ((j, JAnchor), (t, AnchorConfig)):
        assert not m.anchors_initialized
        a_good = A(anchor_id=1, p_AinG=np.zeros(3), prior_cov=np.eye(5) * 1e-6)
        a_bad = A(anchor_id=2, p_AinG=np.ones(3), prior_cov=np.eye(5) * 1e-2)
        m.feed_anchors([a_bad, a_good], n_fix=1)
        assert m.anchors_initialized
        m.feed_anchors([a_good, A(anchor_id=3, p_AinG=np.ones(3) * 2, gamma=0.1, alpha=0.01)])
    assert t.anchor_slot_by_id == j.anchor_slot_by_id == {1: 0, 2: 1, 3: 2}
    P = t.state.cov.numpy()
    off_good, off_bad = (t.layout.anchor_slot_off(t.anchor_slot_by_id[i]) for i in (1, 2))
    np.testing.assert_array_equal(P[off_good : off_good + 5, off_good : off_good + 5], 0.0)
    assert P[off_bad, off_bad] > 0
    assert_states_close(j.state, t.state, "after feed_anchors", atol=1e-12)
    with pytest.raises(ValueError, match="max_anchors"):
        t.feed_anchors([AnchorConfig(anchor_id=10 + k, p_AinG=np.zeros(3)) for k in range(4)])


def _anchor_cfgs(A):
    rng = np.random.default_rng(1)
    return [A(anchor_id=aid, p_AinG=p + rng.normal(scale=0.05, size=3),
              prior_cov=np.diag([0.05**2] * 3 + [0.25**2, 0.025**2])) for aid, (p, g, a) in ANCHORS.items()]


def test_uvio_manager_f32_anchors_fused_frames():
    """A float32 manager with anchors and float64 prior blocks constructs
    and runs fused frames end to end, draining range sets in the step."""
    sim, events = sim_events(6, seed=7, uwb_anchors=ANCHORS)
    mgr = UVioManager(UVioConfig(
        max_slam=4, sigma_pix=sim.params.sigma_pix, cameras=sim_cameras(sim, TCam), max_anchors=4,
        anchors=_anchor_cfgs(AnchorConfig), sigma_range=sim.params.sigma_range, dtype="float32",
        device="cpu", **{**SMALL, "max_imu_batch": 64}))
    assert mgr.state.cov.dtype == torch.float32 and mgr.state.time.dtype == torch.float64
    init_at_start(sim, mgr)
    accepted = 0
    for ev in events:
        {"imu": mgr.feed_imu, "uwb": mgr.feed_uwb, "cam": mgr.feed_features}[ev[0]](*ev[1:])
        if ev[0] == "cam":
            accepted += int(mgr.last_uwb_info["accepted"].sum())
    assert mgr._time_host == float(mgr.state.time) > sim.t_start + 0.5
    assert torch.isfinite(mgr.state.cov).all() and torch.isfinite(mgr.state.p).all()
    assert accepted > 0 and not mgr.uwb_buffer[:-1]


def test_uwb_live_loop_and_overflow_drain_match():
    """14 frames with 4 biased anchors through both managers: range sets
    drain inside the step (2 a frame). Then two camera frames are withheld,
    so 6 sets wait for the next frame, more than the step's 4 rows: both
    managers drain them from the host first, and the frame's own window
    starts at the last drained stamp (no IMU interval is integrated twice)."""
    sim, events = sim_events(14, seed=7, uwb_anchors=ANCHORS)
    cams = [ev for ev in events if ev[0] == "cam"]
    events = [ev for ev in events if ev is not cams[10] and ev is not cams[11]]
    pair = make_pair(
        sim, jcls=JUVioManager, tcls=UVioManager, jconfig=JUVioConfig, tconfig=UVioConfig,
        jextra=dict(anchors=_anchor_cfgs(JAnchor)), textra=dict(anchors=_anchor_cfgs(AnchorConfig)),
        max_slam=4, dt_slam_delay=0.5, max_anchors=4, sigma_range=sim.params.sigma_range,
        max_imu_batch=64)
    init_at_start(sim, pair.j, pair.t)
    drained_to = None
    for ev in events:
        if ev is cams[12]:
            waiting = [s[0] for s in pair.t.uwb_buffer if s[0] < ev[1]]
            assert len(waiting) > pair.t.ucfg.max_uwb_sets_per_frame
            drained_to = waiting[-1]
        pair.feed(ev)
        if ev[0] == "cam":
            assert pair.t.uwb_buffer == pair.j.uwb_buffer
    assert pair.checked == len(pair.tb) == 12
    in_step = [int(b["uwb_mask"].any(axis=1).sum()) for b in pair.tb]
    assert max(in_step[:10]) == 2 and sum(in_step[:10]) >= 12
    over = pair.tb[10]  # the frame after the gap
    assert not over["uwb_mask"].any() and (over["uwb_stamp"] == drained_to).all()
    assert over["imu_t"][0] == drained_to and over["stamp_time"] == cams[12][1]
    assert np.all(np.diff(over["imu_t"]) >= 0)
    assert pair.t._time_host == float(pair.t.state.time) == cams[13][1]
    assert pair.t.distance > 0.5

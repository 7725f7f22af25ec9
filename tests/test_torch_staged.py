"""Port parity, the staged per-frame path (`fused_step=False`): the port's
`VioManager` / `UVioManager` against `uvio_tpu`'s staged managers, float64
on the CPU, both fed the same recorded simulator events (the harness of
`test_torch_manager.py`).

Tolerances: the state agrees to 1e-8 after every frame and every host
mirror exactly (`Pair.check`); every decision is equal: `last_zupt_info`
(`accepted`, `n_imu`; the chi2 only as finite: its compressed system
has rank 8 of 9 and one QR direction differs between LAPACK builds, see
`test_torch_uwb_zupt.py`), `last_msckf_info`
(`tri_ok`, `kept`, `num_used`, `cov_ok`), the UWB drain's accept flags,
the SLAM slot maps, failure counts and anchors. Inside the port, the
staged path is held against the fused one on the same events, and the
difference is the reference's own (to 1e-8).
"""

import numpy as np
import pytest
import torch

from test_torch_manager import _init_options, init_at_start, make_pair, sim_events

from uvio_tpu.uwb_manager import AnchorConfig as JAnchor
from uvio_tpu.uwb_manager import UVioConfig as JUVioConfig
from uvio_tpu.uwb_manager import UVioManager as JUVioManager

from uvio_tpu_torch.uwb_manager import AnchorConfig, UVioConfig, UVioManager

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

TIMING_KEYS = ["timestamp", "uwb", "propagation", "msckf", "slam", "marginalization", "total"]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Decisions:
    """Compares the decisions both staged managers made on each frame."""

    def __init__(self, pair):
        self.pair = pair
        self.n = {"zupt": 0, "zupt_acc": 0, "msckf": 0, "uwb": 0}
        self.anchors = {}  # landmark id -> anchor slots seen
        self._seen = (None, None, None)

    def check(self, where):
        j, t = self.pair.j, self.pair.t
        zj, zt = j.__dict__.get("last_zupt_info"), t.last_zupt_info
        assert (zj is None) == (zt is None), where
        if zt is not None and zt is not self._seen[0]:
            assert zt["accepted"] == zj["accepted"] and zt["n_imu"] == zj["n_imu"], where
            assert np.isfinite(zt["gamma"]) and zt["gamma"] >= 0.0, where
            self.n["zupt"] += 1
            self.n["zupt_acc"] += zt["accepted"]
        mj, mt = j.__dict__.get("last_msckf_info"), t.__dict__.get("last_msckf_info")
        assert (mj is None) == (mt is None), where
        if mt is not None and mt is not self._seen[1]:
            for k in ("tri_ok", "kept", "num_used", "cov_ok"):
                np.testing.assert_array_equal(_np(mt[k]), np.asarray(mj[k]), err_msg=f"{where} {k}")
            self.n["msckf"] += 1
        uj, ut = j.__dict__.get("last_uwb_info"), t.__dict__.get("last_uwb_info")
        assert (uj is None) == (ut is None), where
        if ut is not None and ut is not self._seen[2]:
            np.testing.assert_array_equal(_np(ut["accepted"]), np.asarray(uj["accepted"]), err_msg=where)
            self.n["uwb"] += 1
        self._seen = (zt, mt, ut)
        st = t.state
        for sid, slot, valid in zip(_np(st.slam_id), _np(st.slam_anchor_slot), _np(st.slam_valid)):
            if valid:
                self.anchors.setdefault(int(sid), set()).add(int(slot))

    def run(self, events):
        for ev in events:
            self.pair.feed(ev)
            if ev[0] == "cam":
                self.check(f"frame at t={ev[1]:.2f}")
        return self


def test_staged_mono_msckf_matches():
    sim, events = sim_events(30, seed=3)
    pair = make_pair(sim, fused_step=False)
    init_at_start(sim, pair.j, pair.t)
    d = Decisions(pair).run(events)
    assert d.n["msckf"] >= 20
    t = pair.t
    assert list(t.last_timing) == TIMING_KEYS == list(pair.j.last_timing)
    assert t.last_timing["timestamp"] == t._time_host
    assert all(t.last_timing[k] >= 0.0 for k in TIMING_KEYS)
    assert t.distance > 0.5


def test_staged_slam_matches():
    """30 frames with 8 SLAM slots: landmarks initialized, re-observed,
    failed, re-anchored and freed identically."""
    sim, events = sim_events(30, seed=4)
    pair = make_pair(sim, fused_step=False, max_slam=8, dt_slam_delay=0.8, max_slam_init_per_frame=4)
    init_at_start(sim, pair.j, pair.t)
    d = Decisions(pair).run(events)
    assert len(pair.t.slam_slot_by_fid) >= 4
    assert sum(len(s) > 1 for s in d.anchors.values()) >= 2  # re-anchored landmarks
    assert pair.t.last_timing["slam"] > 0.0
    (jid, jp), (tid, tp) = pair.j.get_active_tracks(), pair.t.get_active_tracks()
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-8)


@pytest.mark.parametrize("explicit", [False, True], ids=["inertial", "explicit"])
def test_staged_static_init_then_zupt_matches(explicit):
    """A still first 2.3 s with static init and ZUPT on (both variants):
    zero-velocity updates are accepted while still and rejected once in
    motion, with the same IMU counts, then the visual update
    runs; same states throughout."""
    sim, events = sim_events(32, seed=6, still_time=2.3)
    jx, tx = _init_options()
    pair = make_pair(sim, fused_step=False, use_static_init=True, try_zupt=True, zupt_explicit=explicit,
                     zupt_max_disparity=3.0, max_imu_batch=64, jextra=jx, textra=tx)
    d = Decisions(pair).run(events)
    assert pair.t.is_initialized and d.n["zupt_acc"] >= 2 and d.n["zupt"] > d.n["zupt_acc"]
    assert pair.t._has_moved and d.n["msckf"] >= 5


def _anchor_cfgs(A):
    from test_torch_uwb_manager import ANCHORS

    return [A(anchor_id=k, p_AinG=p, gamma=g, alpha=a) for k, (p, g, a) in ANCHORS.items()]


def test_staged_uvio_matches():
    """UWB with 4 biased anchors, SLAM and the anchor change, staged: the
    UWB drain (`_pre_visual_update`, set by set from the host) accepts the
    same ranges, and the whole run agrees."""
    from test_torch_uwb_manager import ANCHORS

    sim, events = sim_events(24, seed=7, uwb_anchors=ANCHORS)
    pair = make_pair(
        sim, jcls=JUVioManager, tcls=UVioManager, jconfig=JUVioConfig, tconfig=UVioConfig,
        jextra=dict(anchors=_anchor_cfgs(JAnchor)), textra=dict(anchors=_anchor_cfgs(AnchorConfig)),
        fused_step=False, max_slam=6, dt_slam_delay=0.5, max_anchors=4,
        sigma_range=sim.params.sigma_range, max_imu_batch=64)
    init_at_start(sim, pair.j, pair.t)
    d = Decisions(pair)
    for ev in events:
        pair.feed(ev)
        if ev[0] == "cam":
            assert pair.t.uwb_buffer == pair.j.uwb_buffer
            d.check(f"frame at t={ev[1]:.2f}")
    assert d.n["uwb"] >= 10 and d.n["msckf"] >= 15
    assert sum(len(s) > 1 for s in d.anchors.values()) >= 1
    assert pair.t.distance > 0.5


def _pos_diff(sim, events, mk):
    """Largest per-frame position difference between a staged and a fused
    manager of one package on the same events."""
    staged, fused = mk(False), mk(True)
    init_at_start(sim, staged, fused)
    diffs = []
    for ev in events:
        for m in (staged, fused):
            {"imu": m.feed_imu, "cam": m.feed_features}[ev[0]](*ev[1:])
        if ev[0] == "cam":
            diffs.append(np.abs(_np(staged.state.p) - _np(fused.state.p)).max())
    return np.asarray(diffs)


@pytest.mark.parametrize("slam", [0, 8], ids=["msckf", "slam"])
def test_staged_against_fused(slam):
    """Inside each package, staged against fused on the same events. With
    MSCKF only the two paths are the same arithmetic (1e-10 m); with SLAM
    they differ by design (the staged path drops a landmark the first
    frame its track misses, the fused one when its feature leaves the
    window), by the same amount in both packages."""
    from test_torch_manager import JCam, JVioConfig, JVioManager, SMALL, TCam, VioConfig, VioManager, sim_cameras

    sim, events = sim_events(30, seed=4)
    kw = dict(SMALL, sigma_pix=sim.params.sigma_pix, max_slam=slam, dt_slam_delay=0.8, max_slam_init_per_frame=4)
    dt = _pos_diff(sim, events, lambda f: VioManager(VioConfig(cameras=sim_cameras(sim, TCam), device="cpu",
                                                               fused_step=f, **kw)))
    dj = _pos_diff(sim, events, lambda f: JVioManager(JVioConfig(cameras=sim_cameras(sim, JCam), fused_step=f, **kw)))
    print(f"staged vs fused, max position difference over 30 frames (max_slam={slam}): "
          f"port {dt.max():.3e} m, uvio_tpu {dj.max():.3e} m")
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-8)
    if slam == 0:
        assert dt.max() < 1e-10


def _staged_live(n_frames, device="cpu"):
    """The port's staged `UVioManager` on the staged fixture's scenario:
    `staged_record`s of `n_frames` frames after the warm-up."""
    from uvio_tpu_torch.eval.capture import bench_scenario, drive
    from uvio_tpu_torch.fixtures import STAGED_FRAMES, STAGED_WARM, staged_record

    sim, mgr = bench_scenario(STAGED_WARM + 100, seed=7, max_slam=25, dtype="float64", device=device,
                              fused_step=False)
    drive(sim, mgr, STAGED_WARM)
    recs, before = [], [mgr.__dict__.get("last_msckf_info")]

    def on_frame(k, tc):
        recs.append(staged_record(mgr, tc, lambda x: x.cpu().numpy(), before[0]))
        before[0] = mgr.__dict__.get("last_msckf_info")

    assert drive(sim, mgr, min(n_frames, STAGED_FRAMES), on_frame=on_frame) == min(n_frames, STAGED_FRAMES)
    return {k: np.stack([r[k] for r in recs]) for k in recs[0]}


def test_staged_uvio_live_matches_fixture():
    """`bench.py`'s scenario through the port's staged `UVioManager` from
    the first IMU sample against `uvio_tpu`'s staged run
    (`fixtures/staged_seed7.npz`): every decision equal, position within
    1e-6 m and trace(cov) within 1e-6 relative on every frame (the card's
    gates, `chip_smoke.py` phase `backend`)."""
    from uvio_tpu_torch.fixtures import load_staged_fixture, staged_differences

    ref = load_staged_fixture()
    d = staged_differences(_staged_live(len(ref["t"])), ref)
    assert not d["decisions"], d
    assert d["p_m"] <= 1e-6 and d["cov_trace_rel"] <= 1e-6, d
    assert ref["msckf_ran"].sum() >= 40 and ref["uwb_accepted"].sum() > 100 and (ref["slam_fid"][-1] >= 0).all()


@pytest.mark.slow
def test_staged_fixture_regenerates(tmp_path):
    """scripts/make_staged_fixture.py alone rebuilds the committed fixture,
    array for array (about a minute on the CPU)."""
    import os
    import subprocess
    import sys

    from uvio_tpu_torch.fixtures import STAGED_FIXTURE

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "staged.npz"
    subprocess.run([sys.executable, os.path.join(root, "scripts", "make_staged_fixture.py"), "--out", str(out)],
                   check=True, timeout=900, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    with np.load(out) as new, np.load(STAGED_FIXTURE) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    assert os.path.getsize(STAGED_FIXTURE) <= 300 * 1024

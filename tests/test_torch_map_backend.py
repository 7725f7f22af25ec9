"""Port parity, the keyframe map backend: `uvio_tpu_torch.parallel.
MapBackend` against `uvio_tpu.parallel.MapBackend` (mesh=None), float64
on the CPU.

One recorded simulator run (the scenario of `tests/test_map_backend.py`:
seed 11, a circle, 50 map points, 10 Hz camera, 11 clones; a 7 s circle
here, the full 16 s in the slow twin, each run to its end) goes through
both packages' staged managers, and each backend ingests its own manager
after every frame.

Tolerances: keyframe times and the observation dictionaries' keys are
equal, the keyframe poses and normalized observations agree to 1e-9 (the
managers' states agree to 1e-8 in position, `test_torch_staged.py`);
`refine()`'s keyframe poses, points and costs agree to 1e-8 (relative
for the costs). The eviction is plain host bookkeeping, held exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_manager import JCam, TCam, init_at_start, sim_cameras

from uvio_tpu.manager import VioConfig as JVioConfig
from uvio_tpu.manager import VioManager as JVioManager
from uvio_tpu.parallel import MapBackend as JBackend
from uvio_tpu.parallel import MapBackendOptions as JOpts

from uvio_tpu_torch.manager import VioConfig, VioManager
from uvio_tpu_torch.math import quat_to_rot
from uvio_tpu_torch.parallel import MapBackend, MapBackendOptions
from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

BACKEND = dict(every_n_frames=3, max_keyframes=48, lm_bucket=64)


def _events(duration):
    """(sim, events) of the scenario's simulator run to its end."""
    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=50, seed=11),
                    trajectory=circle_trajectory(duration=duration))
    events = []
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        events.append(("imu", *r))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= r[0]:
            rc = sim.get_next_cam()
            if rc is None:
                break
            events.append(("cam", *rc))
    return sim, events


def _run(duration):
    """Both staged managers and both backends over one recorded run, plus
    the ground-truth camera centre of every ingested keyframe."""
    sim, events = _events(duration)
    kw = dict(max_clones=11, max_msckf_in_update=40, sigma_pix=sim.params.sigma_pix, fused_step=False)
    jm = JVioManager(JVioConfig(cameras=sim_cameras(sim, JCam), **kw))
    tm = VioManager(VioConfig(cameras=sim_cameras(sim, TCam), device="cpu", **kw))
    init_at_start(sim, jm, tm)
    jb, tb = JBackend(JOpts(**BACKEND)), MapBackend(MapBackendOptions(**BACKEND), device="cpu")
    cam = sim.params.cameras[0]
    R_ItoC = quat_to_rot(torch.as_tensor(cam.q_ItoC)).numpy()
    gt_cam_p = {}
    for ev in events:
        for m in (jm, tm):
            {"imu": m.feed_imu, "cam": m.feed_features}[ev[0]](*ev[1:])
        if ev[0] == "cam":
            took = (jb.ingest(jm), tb.ingest(tm))
            assert took[0] == took[1], ev[1]
            if took[1]:
                g = sim.get_gt_state(ev[1])
                R_GtoI = quat_to_rot(torch.as_tensor(g["q_GtoI"])).numpy()
                gt_cam_p[ev[1]] = g["p_IinG"] - R_GtoI.T @ (R_ItoC.T @ cam.p_IinC)
    return sim, jb, tb, gt_cam_p


def _check_maps(jb, tb):
    assert tb.kf_t == jb.kf_t and tb.num_keyframes == jb.num_keyframes
    np.testing.assert_allclose(np.asarray(tb.kf_q), np.asarray(jb.kf_q), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(tb.kf_p), np.asarray(jb.kf_p), rtol=0, atol=1e-9)
    assert sorted(tb.obs) == sorted(jb.obs)
    for fid, o in jb.obs.items():
        assert sorted(tb.obs[fid]) == sorted(o), fid
        for k, uv in o.items():
            np.testing.assert_allclose(tb.obs[fid][k], np.asarray(uv), rtol=0, atol=1e-9)


def _check_refined(jr, tr):
    np.testing.assert_array_equal(tr["kf_t"], jr["kf_t"])
    np.testing.assert_allclose(tr["costs"], np.asarray(jr["costs"]), rtol=1e-8, atol=0)
    np.testing.assert_allclose(tr["kf_q"], np.asarray(jr["kf_q"]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tr["kf_p"], np.asarray(jr["kf_p"]), rtol=0, atol=1e-8)
    assert sorted(tr["points"]) == sorted(jr["points"])
    for fid, p in jr["points"].items():
        np.testing.assert_allclose(tr["points"][fid], np.asarray(p), rtol=0, atol=1e-8)


def test_map_backend_matches_reference():
    """A 7 s circle: ~21 keyframes, then `refine()` on both."""
    _, jb, tb, gt = _run(7.0)
    assert tb.num_keyframes >= 12
    _check_maps(jb, tb)
    jr, tr = jb.refine(), tb.refine()
    _check_refined(jr, tr)
    assert tb.refined is tr and len(tr["points"]) >= 10
    assert tr["costs"][-1] <= tr["costs"][0]
    assert sorted(gt) == list(tr["kf_t"])  # every ingested keyframe kept (no eviction yet)


@pytest.mark.slow
def test_map_backend_e2e_refines_map():
    """The full 16 s run of `tests/test_map_backend.py:45` on both
    packages (mesh=None), with that test's gates on the port."""
    sim, jb, tb, gt = _run(16.0)
    _check_maps(jb, tb)
    assert tb.num_keyframes >= 20
    jr, tr = jb.refine(), tb.refine()
    _check_refined(jr, tr)
    assert tr["costs"][-1] <= tr["costs"][0]
    kf_err = np.linalg.norm(tr["kf_p"] - np.asarray([gt[t] for t in tr["kf_t"]]), axis=1)
    assert np.median(kf_err) < 0.05, (np.median(kf_err), kf_err.max())
    assert len(tr["points"]) >= 20
    errs = np.asarray([np.linalg.norm(p - sim.map_pts[fid]) for fid, p in tr["points"].items()])
    assert np.median(errs) < 0.05, (np.median(errs), errs.max())


def _fill(be):
    for i in range(8):
        be.kf_t.append(float(i))
        be.kf_q.append(np.array([0.0, 0, 0, 1]))
        be.kf_p.append(np.array([float(i), 0, 0]))
    be.obs[100] = {k: np.array([0.1, 0.1]) for k in range(8)}
    be.obs[200] = {2: np.array([0.2, 0.2])}
    be.obs[300] = {k: np.array([0.3, 0.01 * k]) for k in (1, 3, 5)}


def test_map_backend_eviction_matches():
    """`tests/test_map_backend.py::test_map_backend_eviction` on both
    backends, compared after every eviction: the span endpoints survive,
    indices remap contiguously, landmarks whose last keyframe dies go."""
    jb, tb = JBackend(JOpts(max_keyframes=8, every_n_frames=1)), MapBackend(
        MapBackendOptions(max_keyframes=8, every_n_frames=1), device="cpu")
    _fill(jb)
    _fill(tb)
    t_first, t_last = tb.kf_t[0], tb.kf_t[-1]
    for n in range(7, 1, -1):
        jb._evict()
        tb._evict()
        assert tb.num_keyframes == n and tb.kf_t == jb.kf_t
        assert tb.kf_t[0] == t_first and tb.kf_t[-1] == t_last
        assert sorted(tb.obs) == sorted(jb.obs)
        for fid in jb.obs:
            assert sorted(tb.obs[fid]) == sorted(jb.obs[fid])
            assert all(np.array_equal(tb.obs[fid][k], jb.obs[fid][k]) for k in jb.obs[fid])
        assert sorted(tb.obs[100]) == list(range(n))
    assert 200 not in tb.obs or len(tb.obs[200]) > 0
    tb._evict()  # two keyframes: nothing to thin
    assert tb.num_keyframes == 2


def test_refine_needs_a_map():
    be = MapBackend(device="cpu")
    assert be.refine() is None and be.num_keyframes == 0
    assert be.opts.every_n_frames == 4 and be.opts.min_obs == 3 and be.opts.max_keyframes == 64
    assert be.opts.lm_bucket == 128 and be.opts.ba.iters == 10

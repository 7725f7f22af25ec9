"""Port parity, simulator: the float64 B-spline kinematics (closed-form
derivatives in the port, `jax.jacfwd` in `uvio_tpu`) agree to 1e-9 and its
poses (`pose_at`) to 1e-12; the
same seed gives the same IMU stream and feature map; rendered frames
agree to 1e-3 (float32 output of float64 blob sums); the camera tracks
(`get_next_cam`) carry the same ids with uv to 1e-9 and the UWB ranges
(`get_next_uwb`) agree to 1e-9 over 30 frames, mono and stereo; the hard
renderer's frames agree to 1e-3 with each option on and off;
`perturb_calibration` with the same seed gives the same configuration to
1e-12; `load_tum_trajectory` reads a written file."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sims():
    from uvio_tpu.sim import SimCamera as JC
    from uvio_tpu.sim import SimParams as JP
    from uvio_tpu.sim import Simulator as JS
    from uvio_tpu.sim import circle_trajectory as j_traj

    from uvio_tpu_torch.sim import SimCamera as TC
    from uvio_tpu_torch.sim import SimParams as TP
    from uvio_tpu_torch.sim import Simulator as TS
    from uvio_tpu_torch.sim import circle_trajectory as t_traj

    kw = dict(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9)
    cam = dict(width=376, height=240, intrinsics=np.array([229.0, 229.0, 183.5, 124.0, 0, 0, 0, 0]))
    jt, tt = j_traj(duration=6.0, rate_mod=0.3), t_traj(duration=6.0, rate_mod=0.3)
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    return (JS(JP(cameras=[JC(**cam)], **kw), trajectory=jt),
            TS(TP(cameras=[TC(**cam)], **kw), trajectory=tt))


def test_state_at_matches(sims):
    from uvio_tpu.sim import bspline as jb

    from uvio_tpu_torch.sim import bspline as tb

    js, ts = sims
    np.testing.assert_allclose(ts.controls.numpy(), np.asarray(js.controls), atol=1e-12)
    # 50 times, including exact control knots
    t = np.concatenate([np.linspace(js.t_start, js.t_end, 45), js.t0_traj + js.dt_ctrl * np.arange(3, 8)])
    a = jb.state_at_batch(js.controls, js.t0_traj, js.dt_ctrl, jnp.asarray(t))
    b = tb.state_at(ts.controls, ts.t0_traj, ts.dt_ctrl, torch.as_tensor(t))
    for k in ("R_GtoI", "p_IinG", "v_IinG", "a_IinG", "w_IinI"):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=0, atol=1e-9, err_msg=k)


def test_pose_at_matches(sims):
    """`pose_at` over a batch of times (control knots, both ends and
    outside the spline, where the segment index is clamped) is
    `pose_at_batch`'s T_ItoG to 1e-12, and the pose of `state_at`."""
    from uvio_tpu.sim import bspline as jb

    from uvio_tpu_torch.sim import bspline as tb

    js, ts = sims
    t = np.concatenate([np.linspace(js.t_start - 0.5, js.t_end + 0.5, 45), js.t0_traj + js.dt_ctrl * np.arange(3, 8)])
    a = np.asarray(jb.pose_at_batch(js.controls, js.t0_traj, js.dt_ctrl, jnp.asarray(t)))
    b = tb.pose_at(ts.controls, ts.t0_traj, ts.dt_ctrl, torch.as_tensor(t))
    assert b.shape == (len(t), 4, 4) and b.dtype == torch.float64
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-12)
    st = tb.state_at(ts.controls, ts.t0_traj, ts.dt_ctrl, torch.as_tensor(t))
    np.testing.assert_allclose(b[:, :3, :3].numpy(), st["R_GtoI"].transpose(-1, -2).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b[:, :3, 3].numpy(), st["p_IinG"].numpy(), rtol=0, atol=1e-12)


def test_imu_stream_and_map_match(sims):
    js, ts = sims
    np.testing.assert_allclose(ts.map_pts, js.map_pts, rtol=0, atol=1e-9)
    for _ in range(200):
        (t1, w1, a1), (t2, w2, a2) = js.get_next_imu(), ts.get_next_imu()
        assert t1 == t2
        np.testing.assert_allclose(w2, w1, rtol=0, atol=1e-9)
        np.testing.assert_allclose(a2, a1, rtol=0, atol=1e-9)
    g1, g2 = js.get_gt_state(t1), ts.get_gt_state(t2)
    for k in g1:
        np.testing.assert_allclose(g2[k], g1[k], rtol=0, atol=1e-9, err_msg=k)
    assert js.ok() == ts.ok()


def test_render_image_matches(sims):
    js, ts = sims
    for t in (js.t_start + 0.3, js.t_start + 2.05):
        a, b = js.render_image(t), ts.render_image(t)
        assert a.shape == b.shape == (240, 376) and b.dtype == np.float32
        assert np.abs(a - b).max() < 1e-3
        assert b.max() > 150.0  # blobs were drawn


ANCHORS = {
    1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
    2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
    3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
}


@pytest.mark.parametrize("stereo", [False, True])
def test_cam_and_uwb_streams_match(stereo):
    """30 camera frames and the range sets between them, each package's
    simulator driven by the managers' loop: same stamps, same surviving
    ids in the same order, uv and ranges to 1e-9."""
    from uvio_tpu.sim import SimCamera as JC
    from uvio_tpu.sim import SimParams as JP
    from uvio_tpu.sim import Simulator as JS
    from uvio_tpu.sim import circle_trajectory as j_traj

    from uvio_tpu_torch.sim import SimCamera as TC
    from uvio_tpu_torch.sim import SimParams as TP
    from uvio_tpu_torch.sim import Simulator as TS
    from uvio_tpu_torch.sim import circle_trajectory as t_traj

    def cams(C):
        left = C()
        if not stereo:
            return [left]
        return [left, C(p_IinC=np.array([-0.11, 0.0, 0.0]), q_ItoC=np.array([0.0, 0.01, 0.0, 1.0]) / np.sqrt(1.0001),
                        intrinsics=np.array([457.0, 456.0, 379.0, 255.0, -0.28, 0.07, 2e-4, 2e-5]))]

    kw = dict(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=60, seed=7, uwb_anchors=ANCHORS,
              uwb_p_IinU=np.array([0.05, -0.02, 0.1]))
    js = JS(JP(cameras=cams(JC), **kw), trajectory=j_traj(duration=8.0))
    ts = TS(TP(cameras=cams(TC), **kw), trajectory=t_traj(duration=8.0))
    frames = sets = 0
    while frames < 30:
        (t, _, _), (t2, _, _) = js.get_next_imu(), ts.get_next_imu()
        assert t == t2
        if js.cur_uwb_t + 1.0 / js.params.uwb_freq <= t:
            assert ts.cur_uwb_t == js.cur_uwb_t
            (tu1, r1), (tu2, r2) = js.get_next_uwb(), ts.get_next_uwb()
            assert tu1 == tu2 and list(r1) == list(r2)
            np.testing.assert_allclose(list(r2.values()), list(r1.values()), rtol=0, atol=1e-9)
            sets += 1
        if js.cur_cam_t + 1.0 / js.params.sim_freq_cam <= t:
            assert ts.cur_cam_t == js.cur_cam_t
            (tc1, obs1), (tc2, obs2) = js.get_next_cam(), ts.get_next_cam()
            assert tc1 == tc2 and len(obs1) == len(obs2) == (2 if stereo else 1)
            for (ids1, uv1), (ids2, uv2) in zip(obs1, obs2):
                np.testing.assert_array_equal(ids2, ids1)
                assert len(ids1) > 20
                np.testing.assert_allclose(uv2, uv1, rtol=0, atol=1e-9)
            frames += 1
    assert sets >= 55
    assert TS(TP(seed=7), trajectory=t_traj(duration=4.0)).get_next_uwb() is None  # no anchors


HARD_OPTIONS = [
    dict(),
    dict(motion_blur=0.0),
    dict(exposure=False),
    dict(occlusion=False),
    dict(motion_blur=0.0, exposure=False, occlusion=False),
    dict(blob_sigma=2.0, motion_blur=0.02),
]


@pytest.mark.parametrize("opts", HARD_OPTIONS, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_render_image_hard_matches(sims, opts):
    """The adversarial frame (background texture, motion blur, exposure
    ramp, occluder with its seeded pseudo-corners) at 3 stamps: float32
    frames within 1e-3 grey levels of `uvio_tpu`'s."""
    js, ts = sims
    for dt in (0.3, 2.05, 3.6):
        a, b = js.render_image_hard(js.t_start + dt, **opts), ts.render_image_hard(ts.t_start + dt, **opts)
        assert a.shape == b.shape == (240, 376) and b.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-3
        assert 0.0 <= b.min() and b.max() <= 255.0
    if opts.get("occlusion", True) and not opts.get("exposure", True):
        assert (b == 25.0).sum() > 1000 and (b == 230.0).sum() >= 9  # occluder and its corners


def test_render_image_hard_options_change_the_frame(sims):
    _, ts = sims
    t = ts.t_start + 1.0
    base = ts.render_image_hard(t)
    for opts in HARD_OPTIONS[1:4]:
        assert np.abs(ts.render_image_hard(t, **opts) - base).max() > 1.0, opts
    assert np.abs(base - ts.render_image(t)).max() > 10.0


@pytest.mark.parametrize("toggles", [
    dict(),
    dict(calib_imu_intrinsics=True),
    dict(calib_imu_intrinsics=True, imu_model=1, calib_imu_g_sensitivity=True),
    dict(calib_imu_intrinsics=True, calib_imu_g_sensitivity=True, camimu_dt=0.01,
         imu_dw=np.array([1.01, 0.002, -0.003, 0.99, 0.001, 1.02]),
         imu_tg=np.linspace(-1e-3, 1e-3, 9), imu_gq=np.array([0.01, -0.02, 0.005, 1.0]) / np.sqrt(1.000525)),
], ids=["cameras", "kalibr", "rpng+tg", "seeded"])
def test_perturb_calibration_matches(toggles):
    from uvio_tpu.manager import CameraConfig as JCam
    from uvio_tpu.manager import VioConfig as JCfg
    from uvio_tpu.sim import perturb_calibration as j_perturb

    from uvio_tpu_torch.manager import CameraConfig as TCam
    from uvio_tpu_torch.manager import VioConfig as TCfg
    from uvio_tpu_torch.sim import perturb_calibration as t_perturb

    def cams(C):
        return [C(), C(p_IinC=np.array([-0.11, 0.0, 0.0]), q_ItoC=np.array([0.0, 0.01, 0.0, 1.0]) / np.sqrt(1.0001),
                   intrinsics=np.array([457.0, 456.0, 379.0, 255.0, -0.28, 0.07, 2e-4, 2e-5]))]

    for seed in (0, 5):
        a = j_perturb(JCfg(cameras=cams(JCam), **toggles), seed=seed)
        b = t_perturb(TCfg(cameras=cams(TCam), device="cpu", **toggles), seed=seed)
        np.testing.assert_allclose(b.camimu_dt, a.camimu_dt, rtol=0, atol=1e-12)
        assert abs(b.camimu_dt - toggles.get("camimu_dt", 0.0)) > 1e-5
        for ca, cb in zip(a.cameras, b.cameras):
            for k in ("intrinsics", "q_ItoC", "p_IinC"):
                np.testing.assert_allclose(getattr(cb, k), getattr(ca, k), rtol=0, atol=1e-12, err_msg=k)
        for k in ("imu_dw", "imu_da", "imu_tg", "imu_gq", "imu_aq"):
            va, vb = getattr(a, k), getattr(b, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                np.testing.assert_allclose(vb, va, rtol=0, atol=1e-12, err_msg=k)
        assert b.device == "cpu" and len(b.cameras) == 2


def test_load_tum_trajectory(tmp_path):
    """A written `t x y z qx qy qz qw` file: the same arrays as `uvio_tpu`'s
    loader, quaternions normalized, and a simulator runs on it."""
    from uvio_tpu.sim import load_tum_trajectory as j_load

    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory, load_tum_trajectory

    t, q, p = circle_trajectory(duration=4.0)
    path = tmp_path / "traj.txt"
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(len(t)):
            f.write(" ".join(f"{x:.12f}" for x in (t[i], *p[i], *(2.0 * q[i]))) + "\n")
    a, b = j_load(str(path)), load_tum_trajectory(str(path))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    np.testing.assert_allclose(b[1], q, atol=1e-11)  # the factor 2 is normalized away
    sim = Simulator(SimParams(seed=1), trajectory=b)
    assert sim.get_next_imu() is not None and sim.ok()

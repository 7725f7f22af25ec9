"""Port parity, simulator: the float64 B-spline kinematics (closed-form
derivatives in the port, `jax.jacfwd` in `uvio_tpu`) agree to 1e-9; the
same seed gives the same IMU stream and feature map; rendered frames
agree to 1e-3 (float32 output of float64 blob sums)."""

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

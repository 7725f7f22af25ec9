"""Port parity, core: import isolation, layout, quaternion/SO(3)/SE(3)
ops, chi2 table, camera models, state round trip (float64 on the CPU).

Tolerances: the ops are the same closed forms in both packages, so f64
results agree to rounding (1e-10); the camera Jacobians are closed form
in the port and autodiff in `uvio_tpu`, so they agree to 1e-8."""

import itertools
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

T64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a), dtype=T64)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['uvio_tpu'] = None\n"
        "import uvio_tpu_torch.frontend.fused_vio, uvio_tpu_torch.sim, uvio_tpu_torch.pipeline\n"
        "import uvio_tpu_torch.update.slam, uvio_tpu_torch.update.uwb, uvio_tpu_torch.update.zupt\n"
        "import uvio_tpu_torch.fixtures\n"
        "uvio_tpu_torch.fixtures.load_full_step_fixture()\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize(
    "flags", list(itertools.product([False, True], repeat=4))
)
def test_layout_offsets_match(flags):
    from uvio_tpu.types.layout import StateLayout as JL

    from uvio_tpu_torch.types.layout import StateLayout as TL

    kw = dict(
        max_clones=7, max_slam=3, max_anchors=2, num_cams=2,
        calib_cam_timeoffset=flags[0], calib_cam_pose=flags[1],
        calib_cam_intrinsics=flags[2], calib_imu_intrinsics=flags[3],
        calib_imu_g_sensitivity=flags[3], calib_uwb_extrinsics=flags[0],
    )
    a, b = JL(**kw), TL(**kw)
    names = [n for n in dir(type(a)) if isinstance(getattr(type(a), n), property)]
    assert len(names) > 15
    for n in names:
        assert getattr(a, n) == getattr(b, n), n
    for slot in range(3):
        assert a.clone_slot_off(slot) == b.clone_slot_off(slot)
        assert a.slam_slot_off(slot) == b.slam_slot_off(slot)
        assert a.anchor_slot_off(slot) == b.anchor_slot_off(slot)


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.where(q[:, 3:4] < 0, -q, q)


def test_quat_ops_match():
    import uvio_tpu.math.quat_ops as J

    import uvio_tpu_torch.math.quat_ops as T

    rng = np.random.default_rng(0)
    q, p = _rand_quats(rng, 64), _rand_quats(rng, 64)
    w = rng.normal(size=(64, 3))
    w[:4] *= 1e-5  # Taylor branches
    xi = rng.normal(size=(64, 6))
    # rotations near pi exercise log_so3's axis recovery
    w_pi = w / np.linalg.norm(w, axis=1, keepdims=True) * (np.pi - 1e-9)

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-10)

    close(J.skew(w), T.skew(_t(w)))
    close(J.quat_multiply(q, p), T.quat_multiply(_t(q), _t(p)))
    close(J.quat_inv(q), T.quat_inv(_t(q)))
    close(J.quat_to_rot(q), T.quat_to_rot(_t(q)))
    R = np.asarray(J.quat_to_rot(q))
    close(J.rot_to_quat(R), T.rot_to_quat(_t(R)))
    close(J.exp_so3(w), T.exp_so3(_t(w)))
    Rw = np.asarray(J.exp_so3(w))
    close(J.log_so3(Rw), T.log_so3(_t(Rw)))
    Rpi = np.asarray(J.exp_so3(w_pi))
    close(J.log_so3(Rpi), T.log_so3(_t(Rpi)))
    close(J.jl_so3(w), T.jl_so3(_t(w)))
    close(J.jr_so3(w), T.jr_so3(_t(w)))
    close(J.jl_so3_inv(w), T.jl_so3_inv(_t(w)))
    close(J.omega(w), T.omega(_t(w)))
    close(J.exp_se3(xi), T.exp_se3(_t(xi)))
    Txi = np.asarray(J.exp_se3(xi * 0.3))
    close(J.log_se3(Txi), T.log_se3(_t(Txi)))
    close(J.hat_se3(xi), T.hat_se3(_t(xi)))
    close(J.inv_se3(Txi), T.inv_se3(_t(Txi)))
    close(J.rot_to_rpy(R), T.rot_to_rpy(_t(R)))
    close(J.rpy_to_rot(xi[:, :3]), T.rpy_to_rot(_t(xi[:, :3])))
    close(J.quat_to_axis_angle(q), T.quat_to_axis_angle(_t(q)))
    close(J.axis_angle_to_quat(w), T.axis_angle_to_quat(_t(w)))


def test_chi2_matches():
    from uvio_tpu.math.chi2 import chi2_95 as J

    from uvio_tpu_torch.math.chi2 import chi2_95 as T

    dof = np.array([-3, 0, 1, 2, 17, 37, 38, 400, 1024, 5000])
    np.testing.assert_allclose(np.asarray(J(jnp.asarray(dof))), T(torch.as_tensor(dof)).numpy(), atol=1e-10)
    # with a static bound the dof saturates at that bound's quantile
    np.testing.assert_allclose(
        np.asarray(J(jnp.asarray(dof), max_dof=38)), T(torch.as_tensor(dof), max_dof=38).numpy(),
        atol=1e-10,
    )


@pytest.mark.parametrize("model", [0, 1])
def test_camera_models_match(model):
    from uvio_tpu.cam import models as J

    from uvio_tpu_torch.cam import models as T

    rng = np.random.default_rng(model)
    if model == 0:
        intr = np.array([458.0, 457.0, 367.0, 248.0, -0.28, 0.07, 2e-4, 1.8e-5])
    else:
        intr = np.array([190.0, 191.0, 254.0, 256.0, 0.003, 0.02, -0.02, 0.005])
    xy = rng.uniform(-0.6, 0.6, (50, 2))
    uv = np.asarray(J.distort(jnp.asarray(intr), model, jnp.asarray(xy)))

    def close(a, b, tol):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=tol)

    close(uv, T.distort(_t(intr), model, _t(xy)), 1e-10)
    close(J.undistort(jnp.asarray(intr), model, jnp.asarray(uv)), T.undistort(_t(intr), model, _t(uv)), 1e-10)
    p3 = np.concatenate([xy * 4.0, np.full((50, 1), 4.0)], axis=1)
    close(J.project(jnp.asarray(intr), model, jnp.asarray(p3)), T.project(_t(intr), model, _t(p3)), 1e-10)
    Jn, Jc = J.distort_jacobian(jnp.asarray(intr), model, jnp.asarray(xy))
    Tn, Tc = T.distort_jacobian(_t(intr), model, _t(xy))
    close(Jn, Tn, 1e-8)
    close(Jc, Tc, 1e-8)


def test_state_round_trip():
    from uvio_tpu.types import StateLayout, init_state

    from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy

    layout = StateLayout(max_clones=5, max_slam=2, max_anchors=1)
    js = init_state(layout)
    rng = np.random.default_rng(3)
    js = js.replace(
        time=jnp.asarray(1.4e9 + 0.123456789, jnp.float64),
        cov=jnp.asarray(rng.normal(size=(layout.dim, layout.dim))),
        clone_head=jnp.asarray(3, jnp.int32),
        clones_valid=jnp.asarray([True, False, True, True, False]),
    )
    arrays = {n: np.asarray(getattr(js, n)) for n in FIELDS}
    ts = state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert ts.time.dtype == torch.float64 and ts.clones_t.dtype == torch.float64
    back = state_to_numpy(ts)
    for n in FIELDS:
        assert back[n].dtype == arrays[n].dtype, n
        np.testing.assert_array_equal(back[n], arrays[n], err_msg=n)
    # float32 state keeps the time axis in float64
    t32 = state_from_numpy(arrays, device="cpu", dtype=torch.float32)
    assert t32.cov.dtype == torch.float32 and t32.time.item() == arrays["time"]


def test_carry_round_trip():
    from uvio_tpu.frontend.fused_vio import make_fused_vio_step
    from uvio_tpu.types import StateLayout

    from uvio_tpu_torch.types.state import carry_from_numpy, carry_to_numpy

    _, make_carry = make_fused_vio_step(StateLayout(max_clones=5, max_slam=0), np.ones(8), 0,
                                        num_features=12)
    img = np.random.default_rng(4).uniform(0, 255, (48, 64)).astype(np.float32)
    pyr, uv, active, hist_uv, hist_mask = make_carry(img)
    rng = np.random.default_rng(5)
    carry = (
        [np.asarray(lev) for lev in pyr],
        rng.uniform(0, 64, uv.shape).astype(np.float32),
        rng.uniform(size=active.shape) < 0.5,
        rng.uniform(0, 64, hist_uv.shape).astype(np.float32),
        rng.uniform(size=hist_mask.shape) < 0.5,
    )
    tc = carry_from_numpy(carry, device="cpu")
    assert [lev.dtype for lev in tc[0]] == [torch.float32] * 4
    assert tc[2].dtype == tc[4].dtype == torch.bool
    back = carry_to_numpy(tc)
    for a, b in zip(carry[0], back[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(carry[1:], back[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

"""Port parity, UWB and ZUPT: the range Jacobian, the sequential range
updates, and both zero-velocity updates, in float64 on the CPU.

Tolerances: the same closed forms run in both packages, so Jacobians and
single-row updates agree to rounding (1e-10; against torch's own autodiff
too); the ZUPTs go through a QR compression of a 384-row system (and the
explicit one through a 64-sample propagation), so their states agree to
1e-9. The ZUPT chi2 statistic itself is not compared: the compressed
system's 9 columns [theta, bg, ba] have rank 8 (rotation about gravity is
unobservable), so one of the 9 QR directions is an arbitrary unit vector,
different in every LAPACK build, that adds its own share to the
statistic (measured: 1.39e-3 here against 1.29e-3 in JAX). The updated
state is invariant to that direction; the gate decision is compared.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvio_tpu.types import StateLayout as JLayout
from uvio_tpu.types import init_state as j_init

from uvio_tpu_torch.filter.propagator import NoiseManager
from uvio_tpu_torch.types import StateLayout as TLayout
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy

torch.set_num_threads(1)

T64 = torch.float64
ANCHORS = np.array([[4.0, 4.0, 2.0], [-4.0, 4.0, 0.5], [-4.0, -4.0, 2.5], [4.0, -4.0, 1.0]])


def _state(layout, seed=0, v=(0.8, -0.3, 0.1), head=3):
    """A JAX state with a random pose, biases, SPD covariance, 4 biased
    anchors (the last one invalid) and clone slots 0..head valid."""
    rng = np.random.default_rng(seed)
    D, K = layout.dim, layout.max_clones
    A = rng.normal(size=(D, D)) * 0.02
    q = rng.normal(size=4)
    q /= np.linalg.norm(q) * np.sign(q[3])
    cq = np.tile(q, (K, 1))
    valid = np.arange(K) <= head
    p = np.array([1.0, 2.0, 0.5])
    return j_init(layout).replace(
        time=jnp.asarray(3.0), q=jnp.asarray(q), q_fej=jnp.asarray(q),
        p=jnp.asarray(p), p_fej=jnp.asarray(p + 1e-3), v=jnp.asarray(v), v_fej=jnp.asarray(v),
        bg=jnp.asarray(rng.normal(size=3) * 1e-3), ba=jnp.asarray(rng.normal(size=3) * 1e-2),
        clones_q=jnp.asarray(cq), clones_q_fej=jnp.asarray(cq),
        clones_p=jnp.asarray(p + rng.normal(size=(K, 3)) * 1e-3), clones_p_fej=jnp.asarray(np.tile(p, (K, 1))),
        clones_t=jnp.asarray(np.where(valid, 2.0 + 0.1 * np.arange(K), -1.0)),
        clones_valid=jnp.asarray(valid), clone_head=jnp.asarray(head, jnp.int32),
        uwb_p_IinU=jnp.asarray([0.05, -0.02, 0.1]),
        anchors_p=jnp.asarray(ANCHORS[: layout.max_anchors] + rng.normal(size=(layout.max_anchors, 3)) * 0.05),
        anchors_gamma=jnp.asarray([0.15, -0.1, 0.2, 0.0][: layout.max_anchors]),
        anchors_alpha=jnp.asarray([0.01, 0.005, 0.0, 0.02][: layout.max_anchors]),
        anchors_valid=jnp.asarray(np.arange(layout.max_anchors) < 3),
        cov=jnp.asarray(A @ A.T + 1e-3 * np.eye(D)),
    )


def _port(js):
    return state_from_numpy({n: np.asarray(getattr(js, n)) for n in FIELDS}, dtype=T64)


def _assert_states_close(js, ts, atol):
    back = state_to_numpy(ts)
    for n in FIELDS:
        a = np.asarray(getattr(js, n))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(back[n], a, err_msg=n)
        else:
            np.testing.assert_allclose(back[n], a, rtol=0, atol=atol, err_msg=n)


@pytest.mark.parametrize("calib", [False, True])
def test_range_jacobian_matches(calib):
    from uvio_tpu.update.uwb import _range_jacobian as j_jac
    from uvio_tpu.update.uwb import predicted_range as j_pred

    from uvio_tpu_torch.filter.ekf import inject
    from uvio_tpu_torch.update.uwb import _range_jacobian as t_jac
    from uvio_tpu_torch.update.uwb import predicted_range as t_pred

    kw = dict(max_clones=4, max_anchors=4, calib_uwb_extrinsics=calib)
    jl, tl = JLayout(**kw), TLayout(**kw)
    js = _state(jl)
    ts = _port(js)
    for a in range(4):
        Hj, dj = j_jac(js, jl, jnp.int32(a))
        Ht, dt = t_jac(ts, tl, a)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(dt), float(dj), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(t_pred(ts, a)[0]), float(j_pred(js, jnp.int32(a))[0]), atol=1e-12)

        # torch's reverse-mode derivative of the predicted range through the
        # boxplus: the analytic H is the exact Jacobian, anchor block included
        def y_of(dx):
            return t_pred(inject(ts, tl, dx), a)[0]

        if a < 3:  # the boxplus leaves the invalid anchor 3 alone
            Had = torch.func.jacrev(y_of)(torch.zeros(tl.dim, dtype=T64))
            np.testing.assert_allclose(Had.numpy(), Ht[0].numpy(), rtol=0, atol=1e-10)


def test_uwb_update_matches():
    from uvio_tpu.math import quat_to_rot
    from uvio_tpu.update.uwb import uwb_update as j_upd

    from uvio_tpu_torch.update.uwb import uwb_update as t_upd

    kw = dict(max_clones=4, max_anchors=4, calib_uwb_extrinsics=True)
    jl, tl = JLayout(**kw), TLayout(**kw)
    js = _state(jl, seed=1)
    # true ranges from a pose 10 cm away; anchor 0 gets a 3 m outlier,
    # anchor 1 is masked out, anchor 3 is invalid (its mask is set)
    p_true = np.asarray(js.p) + np.array([0.08, -0.05, 0.03])
    R = np.asarray(quat_to_rot(js.q))
    p_U = p_true - R.T @ np.asarray(js.uwb_p_IinU)
    d = np.linalg.norm(np.asarray(js.anchors_p) - p_U, axis=1)
    ranges = (1 + np.asarray(js.anchors_alpha)) * d + np.asarray(js.anchors_gamma)
    ranges[0] += 3.0
    mask = np.array([True, False, True, True])
    j2, ji = j_upd(js, jl, jnp.asarray(ranges), jnp.asarray(mask), sigma_range=0.1)
    t2, ti = t_upd(_port(js), tl, torch.as_tensor(ranges), torch.as_tensor(mask), sigma_range=0.1)
    np.testing.assert_array_equal(ti["accepted"].numpy(), np.asarray(ji["accepted"]))
    np.testing.assert_array_equal(ti["accepted"].numpy(), [False, False, True, False])
    _assert_states_close(j2, t2, 1e-10)
    assert np.abs(np.asarray(j2.p) - np.asarray(js.p)).max() > 1e-5  # the accepted range moved the pose


def _window(layout, js, moving, n=40, M=64):
    """A padded n-sample 200 Hz IMU window of a resting body (the readings
    are bias + gravity in the body frame + 1e-4 noise) or of one rotating
    at 0.5 rad/s."""
    from uvio_tpu.math import quat_to_rot

    rng = np.random.default_rng(3)
    t = 3.0 + np.arange(n) * 0.005
    Rg = np.asarray(quat_to_rot(js.q)) @ np.array([0.0, 0.0, 9.81])
    w = np.asarray(js.bg) + rng.normal(size=(n, 3)) * 1e-4 + (np.array([0.0, 0.0, 0.5]) if moving else 0.0)
    a = np.asarray(js.ba) + Rg + rng.normal(size=(n, 3)) * 1e-3
    pad = M - n
    t = np.concatenate([t, np.full(pad, t[-1])])
    w = np.concatenate([w, np.tile(w[-1], (pad, 1))])
    a = np.concatenate([a, np.tile(a[-1], (pad, 1))])
    return t, w, a


_KW = dict(chi2_mult=1.0, noise_mult=10.0, max_velocity=0.1)


@pytest.mark.parametrize("moving", [False, True])
def test_zupt_try_update_matches(moving):
    from uvio_tpu.filter.propagator import NoiseManager as JN
    from uvio_tpu.update.zupt import zupt_try_update as j_zupt

    from uvio_tpu_torch.update.zupt import zupt_try_update as t_zupt

    kw = dict(max_clones=4, max_anchors=1, max_imu_batch=64)
    jl, tl = JLayout(**kw), TLayout(**kw)
    js = _state(jl, seed=2, v=(0.01, -0.02, 0.0))
    t, w, a = _window(jl, js, moving)
    stamp = t[-1] + 0.001
    jf = jax.jit(partial(j_zupt, layout=jl, noises=JN(), gravity_mag=9.81, **_KW))
    j2, jacc, _ = jf(js, imu_t=jnp.asarray(t), imu_w=jnp.asarray(w), imu_a=jnp.asarray(a),
                      stamp_time=jnp.asarray(stamp))
    t2, tacc, _ = t_zupt(_port(js), tl, *(torch.as_tensor(x) for x in (t, w, a)), NoiseManager(), 9.81,
                          stamp_time=torch.as_tensor(stamp, dtype=T64), **_KW)
    assert bool(tacc) == bool(jacc) == (not moving)
    _assert_states_close(j2, t2, 1e-9)
    assert float(t2.time) == (stamp if not moving else 3.0)


@pytest.mark.parametrize("head", [3, -1])  # the explicit branch; the inertial fallback
def test_zupt_explicit_update_matches(head):
    from uvio_tpu.filter.propagator import NoiseManager as JN
    from uvio_tpu.update.zupt import zupt_explicit_update as j_zupt

    from uvio_tpu_torch.update.zupt import zupt_explicit_update as t_zupt

    kw = dict(max_clones=4, max_anchors=1, max_imu_batch=64)
    jl, tl = JLayout(**kw), TLayout(**kw)
    js = _state(jl, seed=4, v=(0.01, 0.0, -0.01), head=max(head, 0))
    if head < 0:
        js = js.replace(clone_head=jnp.asarray(-1, jnp.int32), clones_valid=jnp.zeros(4, bool))
    t, w, a = _window(jl, js, moving=False)
    stamp = t[-1]
    jf = jax.jit(partial(j_zupt, layout=jl, noises=JN(), gravity_mag=9.81, **_KW))
    j2, jacc, _ = jf(js, imu_t=jnp.asarray(t), imu_w=jnp.asarray(w), imu_a=jnp.asarray(a),
                      stamp_time=jnp.asarray(stamp))
    t2, tacc, _ = t_zupt(_port(js), tl, *(torch.as_tensor(x) for x in (t, w, a)), NoiseManager(), 9.81,
                          stamp_time=torch.as_tensor(stamp, dtype=T64), **_KW)
    assert bool(tacc) and bool(jacc)
    _assert_states_close(j2, t2, 1e-9)

"""Port parity, IMU-intrinsic error states of the propagator
(`calib_imu_intrinsics`, with and without g-sensitivity, both IMU models,
all three integrators), in float64 on the CPU.

Tolerances: the Jacobian helpers are sums of products of the same
numbers (1e-12). The propagated mean agrees to 1e-10 and the covariance
to 1e-10 relative to its largest entry: both packages evaluate the same
closed forms, in another order. Phi's intrinsic columns are first-order
consistent with the mean map, as `test_phi_matches_autodiff` holds the
IMU block: the closed-form F differs from the exact Jacobian at O(dt^2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uvio_tpu.types import StateLayout as JLayout
from uvio_tpu.types import init_state as j_init

from uvio_tpu_torch.types import StateLayout as TLayout
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy

torch.set_num_threads(1)

GRAVITY = 9.81
INTEGRATIONS = ("rk4", "discrete", "analytical")


def _quat(rng, scale):
    q = np.concatenate([rng.normal(size=3) * scale, [1.0]])
    return q / np.linalg.norm(q)


def _setup(seed, imu_model, g_sens, n=9, M=12):
    """(kwargs of both layouts, JAX state, padded IMU window): seeded
    non-identity intrinsics, a random SPD covariance, FEJ points off
    their values, n real samples padded to M."""
    kw = dict(max_clones=3, max_imu_batch=M, calib_imu_intrinsics=True,
              calib_imu_g_sensitivity=g_sens, imu_model=imu_model)
    layout = JLayout(**kw)
    rng = np.random.default_rng(seed)
    D = layout.dim
    A = rng.normal(size=(D, D)) * 0.01
    ident = np.array([1.0, 0, 0, 1, 0, 1]) if imu_model == 0 else np.array([1.0, 0, 1, 0, 0, 1])
    q = _quat(rng, 1.0)
    st = j_init(layout).replace(
        time=jnp.asarray(5.0), q=jnp.asarray(q), p=jnp.asarray(rng.normal(size=3)),
        v=jnp.asarray(rng.normal(size=3)), bg=jnp.asarray(rng.normal(size=3) * 1e-2),
        ba=jnp.asarray(rng.normal(size=3) * 5e-2), q_fej=jnp.asarray(_quat(rng, 1.0)),
        p_fej=jnp.asarray(rng.normal(size=3)), v_fej=jnp.asarray(rng.normal(size=3)),
        calib_imu_dw=jnp.asarray(ident + rng.normal(size=6) * 0.02),
        calib_imu_da=jnp.asarray(ident + rng.normal(size=6) * 0.02),
        calib_imu_tg=jnp.asarray(rng.normal(size=9) * (2e-3 if g_sens else 0.0)),
        calib_imu_gq=jnp.asarray(_quat(rng, 0.02)), calib_imu_aq=jnp.asarray(_quat(rng, 0.02)),
        cov=jnp.asarray(A @ A.T + 1e-4 * np.eye(D)),
    )
    t = 5.0 + 0.005 * np.arange(n)
    w = rng.normal(size=(n, 3)) * 0.5
    a = rng.normal(size=(n, 3)) * 2.0 + np.array([0.0, 0.0, GRAVITY])
    pad = M - n
    window = (np.concatenate([t, np.full(pad, t[-1])]), np.concatenate([w, np.tile(w[-1], (pad, 1))]),
              np.concatenate([a, np.tile(a[-1], (pad, 1))]))
    return kw, st, window


def _port(st):
    return state_from_numpy({n: np.asarray(getattr(st, n)) for n in FIELDS}, device="cpu",
                            dtype=torch.float64)


@pytest.mark.parametrize("imu_model", [0, 1])
def test_h_dm_and_h_tg_match(imu_model):
    from uvio_tpu.filter.propagator import _h_dm as j_h_dm
    from uvio_tpu.filter.propagator import _h_tg as j_h_tg

    from uvio_tpu_torch.filter.propagator import _h_dm, _h_tg

    v = np.random.default_rng(imu_model).normal(size=(4, 3))
    got_dm, got_tg = _h_dm(torch.as_tensor(v), imu_model), _h_tg(torch.as_tensor(v))
    assert got_dm.shape == (4, 3, 6) and got_tg.shape == (4, 3, 9)
    for k in range(4):  # the port's are batched over intervals
        np.testing.assert_allclose(got_dm[k].numpy(), np.asarray(j_h_dm(jnp.asarray(v[k]), imu_model, jnp.float64)),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_tg[k].numpy(), np.asarray(j_h_tg(jnp.asarray(v[k]), jnp.float64)),
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(_h_dm(torch.as_tensor(v[0]), imu_model).numpy(), got_dm[0].numpy())


@pytest.mark.parametrize("integration", INTEGRATIONS)
@pytest.mark.parametrize("g_sens", [False, True])
@pytest.mark.parametrize("imu_model", [0, 1])
def test_propagate_with_intrinsics_matches(imu_model, g_sens, integration):
    from uvio_tpu.filter.propagator import NoiseManager as JN
    from uvio_tpu.filter.propagator import propagate_mean_cov as j_prop

    from uvio_tpu_torch.filter.propagator import NoiseManager as TN
    from uvio_tpu_torch.filter.propagator import propagate_mean_cov as t_prop

    kw, js, win = _setup(3 + imu_model, imu_model, g_sens)
    assert JLayout(**kw).imu_intr_dim == (24 if g_sens else 15)
    stamp = win[0][-1] - 0.003  # a camera-clock stamp off the window's end
    js2, jw = j_prop(js, JLayout(**kw), *map(jnp.asarray, win), JN(), GRAVITY,
                     integration=integration, stamp_time=jnp.asarray(stamp))
    ts2, tw = t_prop(_port(js), TLayout(**kw), *map(torch.as_tensor, win), TN(), GRAVITY,
                     integration=integration, stamp_time=torch.as_tensor(stamp))
    back = state_to_numpy(ts2)
    for n in FIELDS:
        a = np.asarray(getattr(js2, n))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(back[n], a, err_msg=n)
        elif n != "cov":
            np.testing.assert_allclose(back[n], a, rtol=0, atol=1e-10, err_msg=n)
    cov = np.asarray(js2.cov)
    np.testing.assert_allclose(back["cov"], cov, rtol=0, atol=1e-10 * np.abs(cov).max())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-10)
    # the intrinsic block itself never changes, and it now correlates with the IMU block
    s = JLayout(**kw).imu_intr_dim
    np.testing.assert_array_equal(back["cov"][15 : 15 + s, 15 : 15 + s], np.asarray(js.cov)[15 : 15 + s, 15 : 15 + s])
    assert np.abs(back["cov"][:15, 15 : 15 + s] - np.asarray(js.cov)[:15, 15 : 15 + s]).max() > 1e-6


@pytest.mark.parametrize("integration", INTEGRATIONS)
@pytest.mark.parametrize("imu_model,g_sens", [(0, True), (1, True), (0, False)])
def test_phi_intrinsic_columns_match_autodiff(imu_model, g_sens, integration):
    """Phi's intrinsic columns (read off a propagation of the identity
    covariance with zero noise) against `torch.func.jacfwd` of the mean
    map in error coordinates."""
    from uvio_tpu_torch.filter.ekf import inject
    from uvio_tpu_torch.filter.propagator import NoiseManager, propagate_mean_cov
    from uvio_tpu_torch.math import quat_multiply

    kw, js, win = _setup(11, imu_model, g_sens, n=5, M=5)
    layout = TLayout(**kw)
    s, D = layout.imu_intr_dim, layout.dim
    st = _port(js)
    st = st.replace(q_fej=st.q, p_fej=st.p, v_fej=st.v)
    win = tuple(map(torch.as_tensor, win))
    zero = NoiseManager(sigma_w=0.0, sigma_wb=0.0, sigma_a=0.0, sigma_ab=0.0)
    prop = lambda x: propagate_mean_cov(x, layout, *win, zero, GRAVITY, integration=integration)[0]
    ns0 = prop(st)

    def mean_map(dx_intr):
        dx = torch.cat([torch.zeros(15, dtype=torch.float64), dx_intr,
                        torch.zeros(D - 15 - s, dtype=torch.float64)])
        ns = prop(inject(st, layout, dx))
        dq = quat_multiply(ns.q, torch.cat([-ns0.q[:3], ns0.q[3:4]]))
        return torch.cat([2.0 * dq[:3] / dq[3], ns.p - ns0.p, ns.v - ns0.v, ns.bg - ns0.bg, ns.ba - ns0.ba])

    phi_num = torch.func.jacfwd(mean_map)(torch.zeros(s, dtype=torch.float64)).numpy()
    eye = prop(st.replace(cov=torch.eye(D, dtype=torch.float64)))
    phi_ik = eye.cov[:15, 15 : 15 + s].numpy()
    assert np.abs(phi_ik).max() > 1e-3
    np.testing.assert_allclose(phi_ik, phi_num, rtol=2e-3, atol=5e-4)

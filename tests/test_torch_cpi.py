"""Port parity, IMU preintegration (`init/cpi.py`): the midpoint scheme,
CpiV1 (rates averaged or not) and CpiV2 of `uvio_tpu_torch` against
`uvio_tpu`'s, float64 on the CPU, on the port simulator's noisy 200 Hz
IMU cut into padded windows (`select_imu_readings_np`) as the dynamic
initializer cuts them.

Tolerances: preintegrals 1e-10 (the same operations in the same order,
batched over intervals where the reference `vmap`s); the forward-mode
Jacobians in `bg` and `ba` (`torch.func.jacfwd` against `jax.jacfwd`)
1e-8, all finite, with an interval whose bias-corrected rate is exactly
zero among them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvio_tpu.init import cpi as J

from uvio_tpu_torch.filter.propagator import select_imu_readings_np
from uvio_tpu_torch.init import cpi as T
from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

torch.set_num_threads(1)

M = 48  # padded samples per window: 32 real ones at 200 Hz over 0.15 s


@pytest.fixture(scope="module")
def windows():
    """(imu_t (5,M), imu_w (5,M,3), imu_a (5,M,3)): five consecutive
    0.15 s windows of a moving platform, padded by repeating the last
    sample; the last window is cut short so that its tail is longer."""
    sim = Simulator(SimParams(sim_freq_imu=200.0, seed=4),
                    trajectory=circle_trajectory(duration=6.0, lap_s=8.0))
    ts, ws, as_ = [], [], []
    while sim.cur_imu_t < sim.t_start + 2.5:
        t, w, a = sim.get_next_imu()
        ts.append(t)
        ws.append(w)
        as_.append(a)
    ts, ws, as_ = np.asarray(ts), np.stack(ws), np.stack(as_)
    t0 = sim.t_start + 1.0
    bounds = [t0 + 0.15 * i for i in range(5)] + [t0 + 0.15 * 4 + 0.05]
    out = [select_imu_readings_np(ts, ws, as_, bounds[i], bounds[i + 1], M) for i in range(5)]
    return tuple(np.stack(x) for x in zip(*out))


def _jax_batched(fn, imu, *args, **kw):
    f = jax.vmap(lambda t, w, a: fn(t, w, a, *[jnp.asarray(x) for x in args], **kw))
    out = f(*[jnp.asarray(x) for x in imu])
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_close(got, ref, atol):
    for k in ("R_k2tau", "alpha", "beta", "dt"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=atol, err_msg=k)


BG = np.array([0.004, -0.003, 0.002])
BA = np.array([0.05, -0.02, 0.03])


def test_padded_windows(windows):
    imu_t = windows[0]
    n_real = (np.diff(imu_t, axis=1) > 0).sum(1)
    assert n_real.min() == 11 and n_real.max() == 31  # tails of 36 and 16 pads
    assert T.active_pairs(torch.as_tensor(imu_t)) == 31


@pytest.mark.parametrize("n_pairs", [None, "active"])
def test_preintegrate_matches(windows, n_pairs):
    imu = [torch.as_tensor(x) for x in windows]
    n = T.active_pairs(imu[0]) if n_pairs else None
    got = T.preintegrate(*imu, torch.as_tensor(BG), torch.as_tensor(BA), n_pairs=n)
    _assert_close(got, _jax_batched(J.preintegrate, windows, BG, BA), 1e-10)
    # one interval without a batch dimension
    one = T.preintegrate(*[x[2] for x in imu], torch.as_tensor(BG), torch.as_tensor(BA))
    _assert_close(one, {k: v[2] for k, v in _jax_batched(J.preintegrate, windows, BG, BA).items()}, 1e-10)


@pytest.mark.parametrize("imu_avg", [True, False])
def test_preintegrate_v1_matches(windows, imu_avg):
    imu = [torch.as_tensor(x) for x in windows]
    got = T.preintegrate_v1(*imu, torch.as_tensor(BG), torch.as_tensor(BA), imu_avg=imu_avg)
    _assert_close(got, _jax_batched(J.preintegrate_v1, windows, BG, BA, imu_avg=imu_avg), 1e-10)


@pytest.mark.parametrize("imu_avg", [True, False])
def test_preintegrate_v2_matches(windows, imu_avg):
    from scipy.spatial.transform import Rotation

    R_lin = Rotation.from_euler("xyz", [8, -4, 30], degrees=True).as_matrix()
    g = np.array([0.0, 0.0, 9.81])
    imu = [torch.as_tensor(x) for x in windows]
    got = T.preintegrate_v2(*imu, torch.as_tensor(BG), torch.as_tensor(BA), torch.as_tensor(R_lin),
                            torch.as_tensor(g), imu_avg=imu_avg)
    ref = _jax_batched(J.preintegrate_v2, windows, BG, BA, R_lin, g, imu_avg=imu_avg)
    _assert_close(got, ref, 1e-10)


@pytest.mark.parametrize("model", ["midpoint", "cpi_v1"])
def test_bias_jacobians_match_jax(windows, model):
    """d(R_k2tau, alpha, beta)/d(bg, ba) by forward mode in both packages,
    on the five windows and on a sixth whose rate equals the gyro bias on
    every sample (w_hat = 0 exactly: the small-angle branch and `exp_so3`
    at zero angle)."""
    imu_t, imu_w, imu_a = windows
    imu_t = np.concatenate([imu_t, imu_t[:1]])
    imu_w = np.concatenate([imu_w, np.tile(BG, (1, M, 1))])
    imu_a = np.concatenate([imu_a, imu_a[:1]])
    jfn = {"midpoint": J.preintegrate, "cpi_v1": J.preintegrate_v1}[model]
    tfn = {"midpoint": T.preintegrate, "cpi_v1": T.preintegrate_v1}[model]

    def j_flat(b):
        out = jax.vmap(lambda t, w, a: jfn(t, w, a, b[:3], b[3:]))(
            jnp.asarray(imu_t), jnp.asarray(imu_w), jnp.asarray(imu_a))
        return jnp.concatenate([out["R_k2tau"].reshape(6, -1), out["alpha"], out["beta"]], axis=1)

    imu = [torch.as_tensor(x) for x in (imu_t, imu_w, imu_a)]

    def t_flat(b):
        out = tfn(*imu, b[:3], b[3:])
        return torch.cat([out["R_k2tau"].reshape(6, -1), out["alpha"], out["beta"]], dim=1)

    b0 = np.concatenate([BG, BA])
    ref = np.asarray(jax.jacfwd(j_flat)(jnp.asarray(b0)))
    got = torch.func.jacfwd(t_flat)(torch.as_tensor(b0)).numpy()
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    # the zero-rate interval's rotation does not move with ba, and moves
    # with bg as -dt [e_k]_x does to first order
    assert np.abs(got[5, :9, 3:]).max() == 0.0
    assert np.abs(got[5, :9, :3]).max() > 0.01

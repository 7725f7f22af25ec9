"""Port parity, filter core: EKF update, stochastic cloning with ring
wraparound, clone marginalization and rk4 IMU propagation, in float64
on the CPU. The same closed forms run in both packages, so the results
agree to rounding (1e-10; the propagated covariance, which sums 31
interval products, to 1e-9)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uvio_tpu.types import StateLayout as JLayout
from uvio_tpu.types import init_state as j_init

from uvio_tpu_torch.types import StateLayout as TLayout
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy

torch.set_num_threads(1)

LAYOUT_KW = dict(max_clones=5, max_imu_batch=32, max_slam=0)


def _random_state(seed, head=2, fej_offset=1e-3, **extra):
    """A JAX state with a random SPD covariance, a random pose, FEJ
    points off their values, and clone slots 0..head valid."""
    layout = JLayout(**{**LAYOUT_KW, **extra})
    rng = np.random.default_rng(seed)
    D, K = layout.dim, layout.max_clones
    A = rng.normal(size=(D, D)) * 0.01
    cov = A @ A.T + 1e-4 * np.eye(D)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    q *= np.sign(q[3])
    cq = rng.normal(size=(K, 4))
    cq /= np.linalg.norm(cq, axis=1, keepdims=True)
    cq *= np.sign(cq[:, 3:4])
    valid = np.arange(K) <= head
    st = j_init(layout).replace(
        time=jnp.asarray(10.0), q=jnp.asarray(q), p=jnp.asarray(rng.normal(size=3)),
        v=jnp.asarray(rng.normal(size=3)), bg=jnp.asarray(rng.normal(size=3) * 1e-3),
        ba=jnp.asarray(rng.normal(size=3) * 1e-2),
        q_fej=jnp.asarray(q), p_fej=jnp.asarray(rng.normal(size=3) * fej_offset),
        v_fej=jnp.asarray(rng.normal(size=3) * fej_offset),
        clones_q=jnp.asarray(cq), clones_p=jnp.asarray(rng.normal(size=(K, 3))),
        clones_q_fej=jnp.asarray(cq), clones_p_fej=jnp.asarray(rng.normal(size=(K, 3))),
        clones_t=jnp.asarray(np.where(valid, 9.0 + 0.1 * np.arange(K), -1.0)),
        clones_valid=jnp.asarray(valid), clone_head=jnp.asarray(head, jnp.int32),
        cov=jnp.asarray(cov),
    )
    return layout, st


def _port(st):
    return state_from_numpy({n: np.asarray(getattr(st, n)) for n in FIELDS}, device="cpu", dtype=torch.float64)


def _assert_states_close(js, ts, atol):
    back = state_to_numpy(ts)
    for n in FIELDS:
        a = np.asarray(getattr(js, n))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(back[n], a, err_msg=n)
        else:
            np.testing.assert_allclose(back[n], a, rtol=0, atol=atol, err_msg=n)


FULL_LAYOUT = dict(  # every error-state block that inject() touches
    max_slam=2, max_anchors=2, calib_cam_timeoffset=True, calib_cam_pose=True,
    calib_cam_intrinsics=True, calib_uwb_extrinsics=True, calib_imu_intrinsics=True,
    calib_imu_g_sensitivity=True,
)


@pytest.mark.parametrize("extra", [{}, FULL_LAYOUT, dict(FULL_LAYOUT, imu_model=1)])
def test_ekf_update_matches(extra):
    from uvio_tpu.filter.ekf import ekf_update as j_upd

    from uvio_tpu_torch.filter.ekf import ekf_update as t_upd

    layout, js = _random_state(0, **extra)
    if extra:
        js = js.replace(slam_valid=jnp.asarray([True, False]),
                        anchors_valid=jnp.asarray([False, True]))
    rng = np.random.default_rng(1)
    m = 12
    H = rng.normal(size=(m, layout.dim))
    res = rng.normal(size=m) * 0.1
    rd = rng.uniform(0.5, 2.0, m)
    mask = np.arange(m) < 9  # padded rows must stay inert
    js2, jd = j_upd(js, layout, jnp.asarray(H), jnp.asarray(res), jnp.asarray(rd), jnp.asarray(mask))
    ts2, td = t_upd(_port(js), TLayout(**{**LAYOUT_KW, **extra}), torch.as_tensor(H),
                    torch.as_tensor(res), torch.as_tensor(rd), torch.as_tensor(mask))
    _assert_states_close(js2, ts2, 1e-10)
    np.testing.assert_allclose(td["dx"].numpy(), np.asarray(jd["dx"]), atol=1e-10)
    assert bool(td["cov_ok"]) == bool(jd["cov_ok"]) is True


@pytest.mark.parametrize("head", [-1, 2, 4])  # empty ring, middle, wraparound
def test_augment_and_marginalize_match(head):
    from uvio_tpu.filter.ekf import augment_clone as j_aug
    from uvio_tpu.filter.ekf import marginalize_clone as j_marg

    from uvio_tpu_torch.filter.ekf import augment_clone as t_aug
    from uvio_tpu_torch.filter.ekf import marginalize_clone as t_marg

    layout, js = _random_state(2, head=max(head, 0))
    if head < 0:
        js = js.replace(clone_head=jnp.asarray(-1, jnp.int32),
                        clones_valid=jnp.zeros(layout.max_clones, bool))
    tl = TLayout(**LAYOUT_KW)
    w = np.array([0.1, -0.2, 0.3])
    ja = j_aug(js, layout, jnp.asarray(w))
    ta = t_aug(_port(js), tl, torch.as_tensor(w))
    _assert_states_close(ja, ta, 1e-10)
    slot = (int(ja.clone_head) + 1) % layout.max_clones
    jm = j_marg(ja, layout, jnp.asarray(slot, jnp.int32))
    tm = t_marg(ta, tl, torch.as_tensor(slot))
    _assert_states_close(jm, tm, 1e-10)


def test_propagate_and_clone_matches():
    from uvio_tpu.filter.propagator import NoiseManager as JN
    from uvio_tpu.filter.propagator import propagate_and_clone as j_prop
    from uvio_tpu.filter.propagator import select_imu_readings_np as j_sel
    from uvio_tpu.sim import SimParams, Simulator, circle_trajectory

    from uvio_tpu_torch.filter.propagator import NoiseManager as TN
    from uvio_tpu_torch.filter.propagator import propagate_and_clone as t_prop
    from uvio_tpu_torch.filter.propagator import select_imu_readings_np as t_sel

    sim = Simulator(SimParams(sim_freq_imu=200.0, seed=4), trajectory=circle_trajectory(duration=3.0))
    rows = [sim.get_next_imu() for _ in range(60)]
    times = np.array([r[0] for r in rows])
    ws = np.array([r[1] for r in rows])
    accs = np.array([r[2] for r in rows])
    # a 0.15 s window: 31 samples (30 inside + interpolated ends), padded to 32
    t0, t1 = times[3] + 0.002, times[3] + 0.152
    jw = j_sel(times, ws, accs, t0, t1, 32)
    tw = t_sel(times, ws, accs, t0, t1, 32)
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)

    layout, js = _random_state(5)
    js = js.replace(time=jnp.asarray(t0))
    jout = j_prop(js, layout, *map(jnp.asarray, jw), JN(), 9.81, stamp_time=jnp.asarray(t1))
    tout = t_prop(_port(js), TLayout(**LAYOUT_KW), *(torch.as_tensor(x) for x in tw), TN(), 9.81,
                  stamp_time=torch.as_tensor(t1, dtype=torch.float64))
    _assert_states_close(jout, tout, 1e-9)
    assert float(tout.time) == t1


def _imu_window(n_rows=60, seed=4):
    """A 32-sample window (31 inside + interpolated ends, padded by one)
    of a simulated circle trajectory, with its start and end times."""
    from uvio_tpu.sim import SimParams, Simulator, circle_trajectory

    from uvio_tpu_torch.filter.propagator import select_imu_readings_np

    sim = Simulator(SimParams(sim_freq_imu=200.0, seed=seed), trajectory=circle_trajectory(duration=3.0))
    rows = [sim.get_next_imu() for _ in range(n_rows)]
    times = np.array([r[0] for r in rows])
    ws = np.array([r[1] for r in rows])
    accs = np.array([r[2] for r in rows])
    t0, t1 = times[3] + 0.002, times[3] + 0.152
    return select_imu_readings_np(times, ws, accs, t0, t1, 32), t0, t1


@pytest.mark.parametrize("integration", ["discrete", "analytical"])
def test_propagate_mean_cov_integrations_match(integration):
    """The two integrators that the rk4 test above leaves out: mean and
    covariance to 1e-9 (31 interval products, as there)."""
    from uvio_tpu.filter.propagator import NoiseManager as JN
    from uvio_tpu.filter.propagator import propagate_mean_cov as j_prop

    from uvio_tpu_torch.filter.propagator import NoiseManager as TN
    from uvio_tpu_torch.filter.propagator import propagate_mean_cov as t_prop

    win, t0, t1 = _imu_window()
    layout, js = _random_state(6)
    js = js.replace(time=jnp.asarray(t0))
    jout, jw = j_prop(js, layout, *map(jnp.asarray, win), JN(), 9.81, integration=integration)
    tout, tw = t_prop(_port(js), TLayout(**LAYOUT_KW), *(torch.as_tensor(x) for x in win), TN(), 9.81,
                      integration=integration)
    _assert_states_close(jout, tout, 1e-9)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-12)
    assert float(tout.time) == t1


def test_propagate_mean_only_matches():
    from uvio_tpu.filter.propagator import propagate_mean_only as j_prop

    from uvio_tpu_torch.filter.propagator import propagate_mean_only as t_prop

    win, _, _ = _imu_window(seed=7)
    _, js = _random_state(7)
    jq, jp, jv = j_prop(js, *map(jnp.asarray, win), 9.81)
    tq, tp, tv = t_prop(_port(js), *(torch.as_tensor(x) for x in win), 9.81)
    for a, b in ((jq, tq), (jp, tp), (jv, tv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-10)
    assert np.abs(np.asarray(jp) - np.asarray(js.p)).max() > 1e-2  # the window moved the pose


@pytest.mark.parametrize("head", [2, 4])
def test_oldest_clone_slot_matches(head):
    from uvio_tpu.types.state import num_clones as j_num
    from uvio_tpu.types.state import oldest_clone_slot as j_old

    from uvio_tpu_torch.types.state import num_clones as t_num
    from uvio_tpu_torch.types.state import oldest_clone_slot as t_old

    layout, js = _random_state(8, head=head)
    # a wrapped ring: slot 0 is newer than the others
    js = js.replace(clones_t=js.clones_t.at[0].set(20.0))
    ts = _port(js)
    assert int(t_old(ts, TLayout(**LAYOUT_KW))) == int(j_old(js, layout)) == 1
    assert int(t_num(ts)) == int(j_num(js)) == head + 1


@pytest.mark.parametrize("slot", [0, 3])
def test_marginalize_clone_int_slot_is_bit_equal(slot):
    """The slot as a Python int (no index upload) and as a tensor give the
    same state bit for bit."""
    from uvio_tpu_torch.filter.ekf import marginalize_clone as t_marg
    from uvio_tpu_torch.types.state import FIELDS, state_to_numpy

    _, js = _random_state(2, head=4)
    ts, tl = _port(js), TLayout(**LAYOUT_KW)
    a = state_to_numpy(t_marg(ts, tl, torch.as_tensor(slot)))
    b = state_to_numpy(t_marg(ts, tl, slot))
    for n in FIELDS:
        np.testing.assert_array_equal(b[n], a[n], err_msg=n)
    assert not b["clones_valid"][slot] and a["clones_valid"].sum() == state_to_numpy(ts)["clones_valid"].sum() - 1

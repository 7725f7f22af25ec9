"""The traffic copies: the vectorised simulator against the port's, a
generated corridor stream against the recorded one."""

import os

import numpy as np
import pytest
import torch

from port_bench.harness import BENCH_DIR, cell_files
from port_bench.traffic.generate import make_traffic, range_mask
from port_bench.traffic.simulator import SimCamera, SimParams, Simulator

ROOT = os.path.dirname(BENCH_DIR)
ANCHORS = {101: (np.array([2.5, 2.5, 0.5]), 0.25, 0.03), 102: (np.array([-12.5, 2.0, 2.8]), -0.15, -0.02)}


def port_sim(seed, **kw):
    from uvio_tpu_torch.sim import simulator as S

    cam = S.SimCamera(intrinsics=np.array([458.0, 457.0, 367.0, 248.0, -0.28, 0.07, 2e-4, 2e-5]))
    params = S.SimParams(seed=seed, num_pts=40, uwb_anchors=ANCHORS, uwb_freq=10.0, cameras=[cam],
                         uwb_p_IinU=np.array([-0.01, 0.01, 0.05]), **kw)
    return S, params


def test_vectorised_simulator_matches_the_port():
    """The same IMU samples, tracks and ranges as the port's Simulator
    called in its live loop, on a short seeded stream."""
    S, params = port_sim(5)
    traj = S.circle_trajectory(duration=6.0)
    sim = S.Simulator(params, trajectory=traj)
    imu, cams, uwbs = [], [], []
    while True:
        r = sim.get_next_imu()
        if r is None or r[0] > sim.t_start + 2.0:
            break
        imu.append(r)
        if sim.cur_uwb_t + 1.0 / params.uwb_freq <= r[0]:
            uwbs.append(sim.get_next_uwb())
        if sim.cur_cam_t + 1.0 / params.sim_freq_cam <= r[0]:
            cams.append(sim.get_next_cam())
    ours = Simulator(SimParams(**{k: getattr(params, k) for k in (
        "sim_freq_imu", "sim_freq_cam", "sigma_w", "sigma_wb", "sigma_a", "sigma_ab", "sigma_pix",
        "gravity_mag", "num_pts", "min_feature_depth", "max_feature_depth", "map_density_hz",
        "pts_per_spawn", "seed", "uwb_anchors", "uwb_freq", "sigma_range", "uwb_p_IinU")},
        cameras=[SimCamera(intrinsics=params.cameras[0].intrinsics)]), traj)
    st = ours.stream(imu[-1][0])
    assert len(st.imu_t) == len(imu) and len(st.cam_t) == len(cams) and len(st.uwb_t) == len(uwbs)
    np.testing.assert_allclose(st.imu_t, [r[0] for r in imu], rtol=0, atol=1e-12)
    np.testing.assert_allclose(st.imu_w, [r[1] for r in imu], rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.imu_a, [r[2] for r in imu], rtol=0, atol=1e-9)
    for k, (t, obs) in enumerate(cams):
        assert st.cam_t[k] == t
        np.testing.assert_array_equal(st.tracks[k][0][0], obs[0][0])
        np.testing.assert_allclose(st.tracks[k][0][1], obs[0][1], rtol=0, atol=1e-7)
    for j, (t, ranges) in enumerate(uwbs):
        assert st.uwb_t[j] == t
        np.testing.assert_allclose(st.uwb_ranges[j], [ranges[a] for a in st.uwb_ids], rtol=0, atol=1e-9)
    assert [k for k, _ in st.events].count("cam") == len(cams)


def test_corridor_stream_matches_the_recorded_one():
    """Rates, tracks a frame and range biases of the generated corridor
    stream against the recorded `data/streams/uwb`."""
    data = os.path.join(ROOT, "data", "streams", "uwb")
    imu = np.loadtxt(os.path.join(data, "imu.csv.gz"), delimiter=",")
    cam = np.loadtxt(os.path.join(data, "cam.csv.gz"), delimiter=",")
    uwb = np.loadtxt(os.path.join(data, "uwb.csv.gz"), delimiter=",")
    _, config, mix = cell_files("uwb_corridor.live")
    tr = make_traffic(config, mix, 12345678901, 6.0, BENCH_DIR)
    st = tr.stream
    rec_rate = lambda t: (len(t) - 1) / (t[-1] - t[0])  # noqa: E731
    assert rec_rate(st.imu_t) == pytest.approx(rec_rate(imu[:, 0]), rel=1e-3)
    assert rec_rate(st.cam_t) == pytest.approx(rec_rate(np.unique(cam[:, 0])), rel=1e-3)
    assert rec_rate(st.uwb_t) == pytest.approx(rec_rate(np.unique(uwb[:, 0])), rel=1e-3)
    # the range sets lag the IMU clock as the recorded ones do
    assert (st.uwb_t[0] - st.t_begin) % 0.1 == pytest.approx((uwb[0, 0] - imu[0, 0]) % 0.1, abs=1e-3)
    per_frame = [len(f[0][0]) for f in st.tracks]
    rec = np.unique(cam[:, 0], return_counts=True)[1]
    assert np.median(per_frame) == np.median(rec) == 250
    # ranges carry the recorded stream's biases: y = (1 + alpha) d + gamma + n
    truth = np.loadtxt(os.path.join(data, "uwb_truth.csv"), delimiter=",", skiprows=1)
    s = tr.sim.state(st.uwb_t)
    p_U = (s["p_IinG"] - s["R_GtoI"].transpose(-1, -2) @ torch.as_tensor(tr.sim.params.uwb_p_IinU)).numpy()
    for a, aid in enumerate(st.uwb_ids):
        row = truth[truth[:, 0] == aid][0]
        d = np.linalg.norm(p_U - row[1:4], axis=1)
        resid = st.uwb_ranges[:, a] - ((1 + row[5]) * d + row[4])
        assert abs(resid.mean()) < 4 * 0.1 / np.sqrt(len(resid)) + 1e-3 and resid.std() == pytest.approx(0.1, rel=0.3)


def test_range_drops_and_outages():
    t = np.arange(0.0, 100.0, 0.1)
    keep = range_mask(t, 4, {"range_drop_prob": 0.3, "outage_period_s": 10.0, "outage_s": 3.0}, 0.0, 3)
    assert not keep[(t % 10.0) >= 7.0].any()
    assert keep[(t % 10.0) < 7.0].mean() == pytest.approx(0.7, abs=0.05)
    assert range_mask(t, 4, {"range_drop_prob": 0.0}, 0.0, 3).all()

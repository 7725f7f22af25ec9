"""The slice as a whole: hard rendered images -> `KLTTracker` ->
`VioManager` (static init + ZUPT) -> posyaw ATE, through the port on the
CPU (`tests/test_rendered_hard.py`'s pipeline).

Tier-1 case: a reduced camera (320x240, intrinsics scaled), 8 s with 5 s
at rest. The same frames and IMU samples go through `uvio_tpu`'s
tracker, manager and `ate` in the same test, and the port's RANSAC is
fed `uvio_tpu`'s Gumbel noise; LAPACK and float rounding still make the
two runs differ track by track, so the port is held to the gates of the
reference's regression, and to what `uvio_tpu` reaches here plus a
stated margin. The full 752x480, 19 s
scenario of `tests/test_rendered_hard.py` is the second case, marked
slow (minutes on a CPU)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
# the filter's float32 products must be full precision (README "Numerics")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _scenario(width, height, intr, duration, still=5.0):
    """Frames and IMU samples of the hard scenario from the port's
    simulator: (cam, events, gt), events in feeding order."""
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cam = SimCamera(width=width, height=height, intrinsics=np.asarray(intr, float))
    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9, cameras=[cam]),
        trajectory=circle_trajectory(duration=duration, still_time=still),
    )
    events, gt = [], {}
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        events.append(("imu", r))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= r[0]:
            tc = sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam
            sim.cur_cam_t = tc
            events.append(("cam", (tc, sim.render_image_hard(tc))))
            g = sim.get_gt_state(tc)
            gt[tc] = (g["q_GtoI"], g["p_IinG"])
    return cam, events, gt


def _jax_noise(n):
    """The Gumbel noise of `uvio_tpu`'s tracker, frame by frame: its key
    starts at PRNGKey(0) and is split once per tracked frame."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    while True:
        key, sub = jax.random.split(key)
        yield torch.as_tensor(np.array(jax.random.gumbel(sub, (64, 8, n), jnp.float32)))


def _run(pkg, cam, events, gt, num_features, noise=None, **dev):
    """The pipeline of `tests/test_rendered_hard.py` through package
    `pkg` ("uvio_tpu" or "uvio_tpu_torch"): (ate result, n_tracks, mgr).
    `noise` yields the port tracker's RANSAC noise per tracked frame."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    M, ate = mod("manager"), mod("eval").ate
    cfg = M.VioConfig(
        max_clones=11, max_msckf_in_update=40, sigma_pix=2.0, use_static_init=True,
        try_zupt=True, zupt_max_disparity=0.0,
        init_options=mod("init").StaticInitOptions(wait_for_jerk=False),
        cameras=[M.CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC,
                                p_IinC=cam.p_IinC)],
        **dev,
    )
    mgr = M.VioManager(cfg)
    tracker = mod("frontend.tracker").KLTTracker(
        cam.intrinsics, cam.model, num_features=num_features, grid=(6, 8), histeq="HISTOGRAM", **dev)
    est = {"t": [], "q": [], "p": []}
    ref = {"q": [], "p": []}
    n_tracks = []
    for kind, ev in events:
        if kind == "imu":
            mgr.feed_imu(*ev)
            continue
        tc, img = ev
        if noise is not None and n_tracks:
            ids, uvs = tracker.feed(tc, img, gumbel=next(noise))
        else:
            ids, uvs = tracker.feed(tc, img)
        n_tracks.append(len(ids))
        mgr.feed_features(tc, [(ids.astype(np.int64), uvs)])
        if mgr.is_initialized:
            est["t"].append(tc)
            est["q"].append(np.asarray(mgr.state.q.cpu() if dev else mgr.state.q, np.float64))
            est["p"].append(np.asarray(mgr.state.p.cpu() if dev else mgr.state.p, np.float64))
            ref["q"].append(gt[tc][0])
            ref["p"].append(gt[tc][1])
    t = np.asarray(est["t"])
    res = ate(t, np.asarray(est["q"]), np.asarray(est["p"]), t, np.asarray(ref["q"]),
              np.asarray(ref["p"]), method="posyaw")
    return res, n_tracks, mgr


def test_hard_rendered_images_to_filter_ate_small():
    cam, events, gt = _scenario(320, 240, [195.0, 195.0, 156.0, 124.0, 0, 0, 0, 0], duration=8.0)
    n_frames = sum(k == "cam" for k, _ in events)
    assert n_frames >= 70

    res_t, tracks_t, mgr_t = _run("uvio_tpu_torch", cam, events, gt, 100, noise=_jax_noise(100), device="cpu")
    res_j, tracks_j, _ = _run("uvio_tpu", cam, events, gt, 100)
    print({"port": (res_t["n"], res_t["rmse_pos"], res_t["rmse_ori_deg"], min(tracks_t[3:])),
           "uvio_tpu": (res_j["n"], res_j["rmse_pos"], res_j["rmse_ori_deg"], min(tracks_j[3:]))})

    # self-initialized during the still segment and kept tracking: as many
    # initialized frames as `uvio_tpu` (init fires on the same IMU window)
    assert res_t["n"] == res_j["n"] >= 30, (res_t["n"], res_j["n"])
    assert mgr_t.is_initialized and mgr_t.state.cov.device.type == "cpu"
    # the tracker survives exposure cycling + occlusion sweeps
    assert min(tracks_t[3:]) >= 15, min(tracks_t[3:])
    # the reference regression's gates, and `uvio_tpu`'s error on these
    # frames plus a margin of 3 cm / 0.5 deg (the runs differ track by track)
    assert res_t["rmse_pos"] < 0.15 and res_t["rmse_ori_deg"] < 2.5, res_t
    assert res_t["rmse_pos"] <= res_j["rmse_pos"] + 0.03, (res_t["rmse_pos"], res_j["rmse_pos"])
    assert res_t["rmse_ori_deg"] <= res_j["rmse_ori_deg"] + 0.5, (res_t["rmse_ori_deg"], res_j["rmse_ori_deg"])


@pytest.mark.slow
def test_hard_rendered_images_to_filter_ate():
    """`tests/test_rendered_hard.py` as it stands (752x480, 19 s, 150
    features), through the port; slow because it renders and tracks 180
    full-size frames on the CPU."""
    cam, events, gt = _scenario(752, 480, [458.0, 458.0, 367.0, 248.0, 0, 0, 0, 0], duration=19.0)
    res, n_tracks, _ = _run("uvio_tpu_torch", cam, events, gt, 150, device="cpu")
    assert res["n"] >= 100, res["n"]
    assert min(n_tracks[3:]) >= 15, min(n_tracks[3:])
    assert res["rmse_pos"] < 0.15, res
    assert res["rmse_ori_deg"] < 2.5, res

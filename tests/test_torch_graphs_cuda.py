"""The graphed steps on the card (`graphs.graphed`, the port's `jax.jit`)
against their eager selves on the same card: the full step on the
committed fixture (and the managers' packed-bundle step live), the
batched full and MSCKF-only steps, the fused image->pose step, the KLT
tracker's `feed`, the staged `VioManager` and `UVioManager` frame for
frame (every stage, the UWB drain, ZUPT and the anchor change bitwise,
one graph a stage whatever the slot), IMU-rate poses, and the stereo and
descriptor trackers' `feed`s (every hand-kernel launch after a key's
first call from a replay). For each: every info and decision equal, float64
states within 1e-12 relative (the largest printed), one graph captured a
distinct key met, no host sync in a replay
(`torch.cuda.set_sync_debug_mode("error")`), a result kept from frame k
unchanged after frame k+1; the hand kernels counted once a replay. A
capture that cannot succeed raises. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda -s tests/test_torch_graphs_cuda.py
"""

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from uvio_tpu_torch.fixtures import load_batched_fixture, load_full_step_fixture, stage_batched_fixture
from uvio_tpu_torch.frontend import kernels as K
from uvio_tpu_torch.graphs import graphed
from uvio_tpu_torch.pipeline import (
    FullStepConfig,
    HostPipeline,
    StepConfig,
    bundle_from_numpy,
    make_batched_full_step,
    make_batched_step,
    make_full_step,
    make_packed_full_step,
    pack_bundle,
    plan_frame,
)
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy

pytestmark = pytest.mark.cuda
T64 = torch.float64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _rel(x, y):
    """The largest difference of two float tensors relative to y's scale."""
    x, y = x.double(), y.double()
    return float((x - y).abs().max() / y.abs().max().clamp(min=1e-300))


def _compare(graph_out, eager_out, what, worst):
    """Every non-float leaf equal, every float leaf within 1e-12 relative
    (float64) or equal (float32); `worst` collects the largest."""
    for g, e in zip(tree_leaves(graph_out), tree_leaves(eager_out), strict=True):
        if not isinstance(g, torch.Tensor):
            assert g == e, what
        elif g.dtype == T64 and g.numel():
            worst.append(_rel(g, e))
            assert worst[-1] <= 1e-12, (what, worst[-1])
        else:
            assert torch.equal(g, e), what


def _replay_without_sync(call):
    """call() with a sync debug mode that raises at any host sync."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def test_full_step_graph_equals_eager(dev):
    fx = load_full_step_fixture()
    step = make_full_step(FullStepConfig.from_dict(fx.config))
    g_st = e_st = state_from_numpy(fx.state0, dev)
    t, plans, worst = float(fx.state0["time"]), [], []
    kept = None
    for k, b in enumerate(fx.bundles[:40]):
        plan = plan_frame(b, t)
        plans.append(plan)
        fb = bundle_from_numpy(b, dev)
        if plan in plans[:-1]:  # a key met before: the step is one replay
            g_st, g_info = _replay_without_sync(lambda: step(g_st, fb, plan))
        else:
            g_st, g_info = step(g_st, fb, plan)
        e_st, e_info = step.eager(e_st, fb, plan)
        _compare((g_st, g_info), (e_st, e_info), f"frame {k}", worst)
        if k == 10:
            kept = (g_st, [x.clone() for x in tree_leaves(g_st)])
        t = float(b["stamp_time"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(kept[0]), kept[1]))  # no aliasing
    assert step.stats()["graphs"] == len(set(plans)) >= 2
    print(f"full step: {len(set(plans))} graphs over {len(plans)} frames, "
          f"states within {max(worst):.3g} relative of eager, {step.stats()}")


def test_packed_step_and_manager_graph_equal_eager(dev):
    """The managers' step from a pinned packed bundle, and a live
    `UVioManager` against its own eager twin on bench.py's scenario."""
    from uvio_tpu_torch.eval.capture import bench_scenario, drive

    fx = load_full_step_fixture()
    step = make_packed_full_step(FullStepConfig.from_dict(fx.config))
    st = state_from_numpy(fx.state0, dev)
    plan = plan_frame(fx.bundles[0], float(fx.state0["time"]))
    flat, shapes = pack_bundle(fx.bundles[0], dev)
    assert flat.is_pinned() and flat.device.type == "cpu"
    first = step(st, flat, shapes, plan)
    again = _replay_without_sync(lambda: step(st, flat, shapes, plan))
    eager = step.eager(st, flat, shapes, plan)
    worst = []
    _compare(first, eager, "packed, capture", worst)
    _compare(again, eager, "packed, replay", worst)

    runs = {}
    for mode in ("graph", "eager"):
        sim, mgr = bench_scenario(40, dtype="float64")
        if mode == "eager":
            mgr.full_step = mgr.full_step.eager
        poses = []
        drive(sim, mgr, 40, on_frame=lambda k, t: poses.append(np.concatenate(mgr.get_pose())))
        runs[mode] = (np.asarray(poses), mgr)
    g, e = runs["graph"][0], runs["eager"][0]
    assert g.shape == e.shape and float(np.abs(g - e).max()) <= 1e-9
    graphs = runs["graph"][1].full_step.stats()["graphs"]
    assert 1 <= graphs <= 8
    print(f"manager: 40 frames, poses within {float(np.abs(g - e).max()):.3g} of eager, {graphs} graphs")


def test_batched_steps_graph_equal_eager(dev):
    fx = load_batched_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    step = make_batched_full_step(cfg)
    state0, staged = stage_batched_fixture(fx, frames=20, device=dev, dtype=T64)
    g_st = e_st = state0
    unions, worst = [], []
    for k, (fb, plan) in enumerate(staged):
        unions.append(plan.union)
        if plan.union in unions[:-1]:
            g_st, g_info = _replay_without_sync(lambda: step(g_st, fb, plan))
        else:
            g_st, g_info = step(g_st, fb, plan)
        e_st, e_info = step.eager(e_st, fb, plan)
        _compare((g_st, g_info), (e_st, e_info), f"batched frame {k}", worst)
    assert step.stats()["graphs"] == len(set(unions))

    # the MSCKF-only batched step, its inputs staged by HostPipeline's
    # thread while the first call captures
    from uvio_tpu_torch.filter.propagator import NoiseManager
    from uvio_tpu_torch.types import StateLayout

    sfx = load_full_step_fixture()
    c = sfx.config
    bstep = make_batched_step(StepConfig(layout=StateLayout(**c["layout"]), noises=NoiseManager(**c["noises"]),
                                         sigma_pix=c["sigma_pix"]))
    names = ("imu_t", "imu_w", "imu_a", "msckf_uv", "msckf_mask")
    chunks = [[np.stack([np.asarray(b[n])] * 3) for n in names] for b in sfx.bundles[:6]]
    g_st = e_st = state_from_numpy({n: np.stack([v] * 3) for n, v in sfx.state0.items()}, dev)
    for k, args in enumerate(HostPipeline(chunks, device=dev)):
        g_st, g_info = bstep(g_st, *args)
        e_st, e_info = bstep.eager(e_st, *args)
        _compare((g_st, g_info), (e_st, e_info), f"batched MSCKF frame {k}", worst)
    assert bstep.stats()["graphs"] == 1
    print(f"batched: {step.stats()['graphs']} + 1 graphs, states within {max(worst):.3g} relative of eager")


def _slice_inputs(dev, n):
    """n+1 rendered 752x480 frames, their IMU windows and a float64 state
    (the slice of chip_smoke.py at float64)."""
    from uvio_tpu_torch.filter.propagator import select_imu_readings_np
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory
    from uvio_tpu_torch.types import StateLayout, init_state

    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9),
                    trajectory=circle_trajectory(duration=6.0))
    imgs, stamps, imu = [], [], []
    while len(imgs) < n + 1:
        t, wm, am = sim.get_next_imu()
        imu.append((t, *wm, *am))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            sim.cur_cam_t += 1.0 / sim.params.sim_freq_cam
            imgs.append(sim.render_image(sim.cur_cam_t))
            stamps.append(sim.cur_cam_t)
    imu = np.asarray(imu)
    cam = sim.params.cameras[0]
    layout = StateLayout(max_clones=11, max_imu_batch=32, max_slam=0)
    g0 = sim.get_gt_state(stamps[0])
    on = lambda x, dt=T64: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    st = init_state(layout, dtype=T64, device=dev).replace(
        time=on(stamps[0]), q=on(g0["q_GtoI"]), p=on(g0["p_IinG"]), v=on(g0["v_IinG"]),
        q_fej=on(g0["q_GtoI"]), p_fej=on(g0["p_IinG"]), v_fej=on(g0["v_IinG"]),
        calib_cam_q=on(cam.q_ItoC)[None], calib_cam_p=on(cam.p_IinC)[None], calib_cam_intr=on(cam.intrinsics)[None],
        cov=on(np.diag([1e-5] * 6 + [1e-4] * 3 + [1e-5] * 6 + [0.0] * (layout.dim - 15))))
    windows, cur = [], stamps[0]
    for i in range(1, n + 1):
        t, w, a = select_imu_readings_np(imu[:, 0], imu[:, 1:4], imu[:, 4:7], cur, stamps[i], 32)
        windows.append((on(t), on(w), on(a), on(stamps[i])))
        cur = stamps[i]
    return cam, layout, st, [on(im, torch.float32) for im in imgs], windows


def test_fused_step_graph_equals_eager(dev):
    from uvio_tpu_torch.frontend.fused_vio import make_fused_vio_step

    cam, layout, st0, frames, windows = _slice_inputs(dev, 12)
    step, make_carry = make_fused_vio_step(layout, cam.intrinsics, cam.model, device=dev, sigma_pix=2.0)
    gens = [torch.Generator(device=dev).manual_seed(0) for _ in range(2)]
    g = e = (st0, make_carry(frames[0]))
    worst = []
    for i, w in enumerate(windows):
        K.reset_launch_counts()
        if i:
            gs, gc, gi = _replay_without_sync(lambda: step(*g, frames[i + 1], *w, generator=gens[0]))
        else:
            gs, gc, gi = step(*g, frames[i + 1], *w, generator=gens[0])
        assert K.launch_counts == {"fast9": 1, "lk_track": 1, "lk_level": 0, "uwb_update": 0,
                                   "slam_init": 0, "msckf_update": 1}, (i, K.launch_counts)
        es, ec, ei = step.eager(*e, frames[i + 1], *w, generator=gens[1])
        _compare((gs, gc, gi), (es, ec, ei), f"fused step {i}", worst)
        g, e = (gs, gc), (es, ec)
    assert step.graphed.stats()["graphs"] == 1
    assert int(gi["num_tracks"]) > 100 and bool(gi["cov_ok"])
    print(f"fused step: 1 graph, {len(windows)} steps, states within {max(worst):.3g} relative of eager, "
          f"{step.graphed.stats()}")


def test_tracker_graph_equals_eager(dev):
    from uvio_tpu_torch.frontend.klt import gumbel_noise
    from uvio_tpu_torch.frontend.tracker import KLTTracker
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9),
                    trajectory=circle_trajectory(duration=8.0))
    cam = sim.params.cameras[0]
    frames = []
    for _ in range(12):
        t, _ = sim.get_next_cam()
        frames.append((t, sim.render_image_hard(t)))
    kw = dict(num_features=150, grid=(6, 8), histeq="HISTOGRAM")
    a, b = KLTTracker(cam.intrinsics, cam.model, **kw), KLTTracker(cam.intrinsics, cam.model, **kw)
    b.step_first, b.step_track = b.step_first.eager, b.step_track.eager
    for k, (t, img) in enumerate(frames):
        K.reset_launch_counts()
        ids_a, uv_a = a.feed(t, img)
        assert K.launch_counts == {"fast9": 1, "lk_track": 1 if k else 0, "lk_level": 0, "uwb_update": 0,
                                   "slam_init": 0, "msckf_update": 0}, (k, K.launch_counts)
        ids_b, uv_b = b.feed(t, img)
        assert np.array_equal(ids_a, ids_b) and np.array_equal(uv_a, uv_b), k
        assert np.array_equal(a.active, b.active)
    assert a.step_first.stats()["graphs"] == 1 and a.step_track.stats()["graphs"] == 1
    assert len(ids_a) >= 50
    # a replay of the tracking graph waits for nothing
    img_d, tab = a._upload(frames[-1][1]), a._upload_table()
    noise = gumbel_noise((64, 8, a.cap), torch.Generator(device=dev).manual_seed(1), dev)
    pyr, packed = _replay_without_sync(lambda: a.step_track(a.prev_pyr, img_d, tab, noise))
    assert packed.shape[1] == 4 and len(pyr) == a.levels  # [uv | tracked | LK ok]


def test_failed_capture_raises(dev):
    """A body that reads the card on the host, or copies pageable host data
    to it, cannot be captured: the call raises, and graphs still work."""
    x = torch.arange(4.0, device=dev)
    with pytest.raises(RuntimeError, match="capture"):
        graphed(lambda y: y * float(y.sum().item()), "reads back")(x)
    with pytest.raises(RuntimeError, match="capture"):
        graphed(lambda y: y + torch.tensor([1.0, 2.0, 3.0, 4.0]).to(y.device), "pageable copy")(x)
    ok = graphed(lambda y: y * 2.0, "fine")
    assert torch.equal(ok(x), x * 2.0) and torch.equal(ok(x + 1), (x + 1) * 2.0)
    assert ok.stats()["graphs"] == 1


def _stages(mgr):
    return sorted(n for n in vars(mgr) if n.startswith("_stage_"))


def _replaying(mgr, calls):
    """Every graphed stage of `mgr` called through a wrapper that, once the
    stage holds its graph (one key a stage here, so every later call is a
    replay), calls it with no host sync allowed; `calls[name]` collects
    the slot values the stage was given."""
    for name in _stages(mgr):
        stage = getattr(mgr, name)

        def call(*args, _stage=stage, _name=name, **kwargs):
            slot = kwargs.get("slot", kwargs.get("marg_slot"))
            calls.setdefault(_name, []).append(None if slot is None else int(slot))
            if _stage.entries:
                return _replay_without_sync(lambda: _stage(*args, **kwargs))
            return _stage(*args, **kwargs)

        call.eager, call.graphed = stage.eager, stage
        setattr(mgr, name, call)


def _eager(mgr):
    for name in _stages(mgr):
        setattr(mgr, name, getattr(mgr, name).eager)


def _assert_states_equal(a, b, what):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)


def _rest_then_motion(dev, fused_step=False):
    """The mono scenario of chip_smoke.py's manager phase: seed 9, 2 s at
    rest, static init and ZUPT, float64, as a staged `VioManager`."""
    from uvio_tpu_torch.init.static_init import StaticInitOptions
    from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=60, seed=9),
                    trajectory=circle_trajectory(duration=14.0, still_time=2.0))
    cam = sim.params.cameras[0]
    mgr = VioManager(VioConfig(
        max_clones=11, sigma_pix=sim.params.sigma_pix, dtype="float64", use_static_init=True, try_zupt=True,
        zupt_max_disparity=3.0, init_options=StaticInitOptions(window_time=1.0, imu_thresh=0.1),
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)],
        fused_step=fused_step))
    return sim, mgr


@pytest.mark.parametrize("which", ["VioManager", "UVioManager"])
def test_staged_manager_graphs_equal_eager(dev, which):
    """A staged manager graphed against its eager twin on the same events,
    frame for frame bitwise (state, slot maps, the ZUPT and UWB decisions),
    every replay of a stage with no host sync, and one graph a stage
    however many slot values the marginalizations pass: the mono
    rest-then-motion run (static init, ZUPT, 30 frames), and `bench.py`'s
    scenario (UWB drain, SLAM, anchor changes; 26 frames, past its first
    SLAM inits)."""
    from uvio_tpu_torch.eval.capture import bench_scenario, drive

    if which == "VioManager":
        make, n = (lambda: _rest_then_motion(dev)), 30
    else:
        make, n = (lambda: bench_scenario(60, seed=7, max_slam=25, dtype="float64", fused_step=False)), 26
    (sim_g, g), (sim_e, e) = make(), make()
    calls = {}
    _replaying(g, calls)
    _eager(e)
    for k in range(n):
        assert drive(sim_g, g, 1) == drive(sim_e, e, 1) == 1
        _assert_states_equal(g.state, e.state, f"frame {k}")
        assert g.slot_times == e.slot_times and g.slam_slot_by_fid == e.slam_slot_by_fid, k
        for info in ("last_zupt_info", "last_uwb_info"):
            gi, ei = g.__dict__.get(info), e.__dict__.get(info)
            assert (gi is None) == (ei is None), (k, info)
            if gi is not None:
                assert all(torch.equal(torch.as_tensor(gi[x]), torch.as_tensor(ei[x])) for x in gi), (k, info)
    assert g.is_initialized
    ran = {name for name, c in calls.items() if c}
    want = {"_stage_prop", "_stage_msckf", "_stage_marg"} | (
        {"_stage_zupt"} if which == "VioManager" else
        {"_stage_slam_up", "_stage_slam_init", "_stage_anchor_change", "_stage_prop_only", "_stage_uwb"})
    assert want <= ran, want - ran
    for name in ran:
        assert getattr(g, name).graphed.stats()["graphs"] == 1, name
    assert len(set(calls["_stage_marg"])) >= 5  # one graph, many slot values
    print(f"{which}: {n} frames bitwise equal to eager; stages {sorted(ran)}, "
          f"marginalized slots {sorted(set(calls['_stage_marg']))}, one graph each")


def test_propagated_pose_graph_equals_eager(dev):
    """50 IMU-rate poses of a staged `UVioManager` between two frames: the
    graphed mean-only propagation against its eager body bitwise, each
    replay with no host sync, one graph for every window."""
    from uvio_tpu_torch.eval.capture import bench_scenario, drive

    sim, mgr = bench_scenario(40, seed=7, max_slam=25, dtype="float64", fused_step=False)
    drive(sim, mgr, 12)
    calls = {}
    _replaying(mgr, calls)
    graphed_call = mgr._stage_fast_prop
    for i in range(50):
        t, w, a = sim.get_next_imu()
        mgr.feed_imu(t, w, a)
        mgr._stage_fast_prop = graphed_call
        got = mgr.get_propagated_pose(t)
        mgr._stage_fast_prop = graphed_call.eager
        ref = mgr.get_propagated_pose(t)
        assert all(np.array_equal(x, y) for x, y in zip(got, ref)), i
    assert len(calls["_stage_fast_prop"]) == 50 and graphed_call.graphed.stats()["graphs"] == 1
    assert float(np.linalg.norm(got[1] - mgr.get_pose()[1])) > 0.0


def _rendered(n, stereo=False):
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cams = [SimCamera(), SimCamera(p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=cams),
                    trajectory=circle_trajectory(duration=10.0))
    frames = []
    for _ in range(n):
        t, _ = sim.get_next_cam()
        frames.append((t, sim.render_image(t, cam_idx=0)) + ((sim.render_image(t, cam_idx=1),) if stereo else ()))
    return cams, frames


def test_descriptor_tracker_graph_equals_eager(dev):
    """12 `DescriptorTracker.feed`s graphed against eager: the same ids and
    corners every frame, 1 `fast9` a `feed` (from a replay on every `feed`
    after the first of each key), one graph a step, no host sync in a
    replay of the matching step."""
    from uvio_tpu_torch.frontend.descriptor import DescriptorTracker

    cams, frames = _rendered(12)
    a, b = DescriptorTracker(cams[0].intrinsics, cams[0].model, grid=(6, 8)), \
        DescriptorTracker(cams[0].intrinsics, cams[0].model, grid=(6, 8))
    b.step_first, b.step_match = b.step_first.eager, b.step_match.eager
    for k, (t, img) in enumerate(frames):
        K.reset_launch_counts()
        ids_a, uv_a = a.feed(t, img)
        assert K.launch_counts == {"fast9": 1, "lk_track": 0, "lk_level": 0, "uwb_update": 0,
                                   "slam_init": 0, "msckf_update": 0}, (k, K.launch_counts)
        assert K.replay_counts["fast9"] == (0 if k < 2 else 1), (k, K.replay_counts)
        ids_b, uv_b = b.feed(t, img)
        assert np.array_equal(ids_a, ids_b) and np.array_equal(uv_a, uv_b), k
    assert a.step_first.stats()["graphs"] == a.step_match.stats()["graphs"] == 1
    assert len(ids_a) >= 15
    _, p_desc, p_valid, _ = a.prev
    img_d = torch.as_tensor(frames[-1][1], dtype=torch.float32, device=dev)
    desc, valid, packed = _replay_without_sync(lambda: a.step_match(p_desc, p_valid, img_d))
    assert packed.shape == (48, 4)


def test_stereo_tracker_graph_equals_eager(dev):
    """12 `StereoKLTTracker.feed`s graphed against eager: the same left and
    right observations every frame, 1 `fast9` + 2 `lk_track` a `feed` (1 +
    1 on the first), all from replays from the third `feed` on and the
    stereo match's from the first tracking one; one graph for every track
    count; no host sync in a replay of the stereo step."""
    from uvio_tpu_torch.frontend.stereo import StereoKLTTracker
    from uvio_tpu_torch.frontend.tracker import to_device

    cams, frames = _rendered(12, stereo=True)
    make = lambda: StereoKLTTracker(cams[0].intrinsics, cams[1].intrinsics, cams[0].model,
                                    num_features=120, grid=(6, 8))
    a, b = make(), make()
    for name in ("step_first", "step_track", "step_stereo"):
        setattr(b.left, name, getattr(b.left, name).eager)
    counts = set()
    for k, (t, left, right) in enumerate(frames):
        K.reset_launch_counts()
        obs_a = a.feed(t, left, right)
        assert K.launch_counts == {"fast9": 1, "lk_track": 2 if k else 1, "lk_level": 0, "uwb_update": 0,
                                   "slam_init": 0, "msckf_update": 0}, (k, K.launch_counts)
        want = {0: (0, 0), 1: (0, 1)}.get(k, (1, 2))
        assert (K.replay_counts["fast9"], K.replay_counts["lk_track"]) == want, (k, K.replay_counts)
        obs_b = b.feed(t, left, right)
        for (ia, ua), (ib, ub) in zip(obs_a, obs_b):
            assert np.array_equal(ia, ib) and np.array_equal(ua, ub), k
        counts.add(len(obs_a[0][0]))
    assert len(counts) >= 2 and a.left.step_stereo.stats()["graphs"] == 1
    tr = a.left
    tab = to_device(np.concatenate([tr.uv, tr.active[:, None]], axis=1), dev)
    img_d = tr._upload(frames[-1][2])
    packed = _replay_without_sync(lambda: tr.step_stereo(tr.prev_pyr, img_d, tab))
    assert packed.shape == (tr.cap, 3)

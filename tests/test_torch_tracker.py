"""Port parity, the KLT tracker: `uvio_tpu_torch.frontend.tracker.KLTTracker`
against `uvio_tpu`'s on 12 hard rendered frames of a reduced camera
(320x240, intrinsics scaled, 60 features, grid 6x8), both on the CPU.

RANSAC differs between LAPACK builds on a few slots, a flipped track
frees a slot, and `_spawn` then hands out ids in another order: two
free-running trackers drift apart in ids though both are right. So
parity is held frame by frame with the JAX tracker's state forced into
the port's (teacher-forced) and its Gumbel noise fed to the port's
RANSAC; the free-running port is held to the gates of
`tests/test_frontend.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N_FRAMES = 12
CAP = 60
GRID = (6, 8)
INTR = np.array([195.0, 195.0, 156.0, 124.0, 0, 0, 0, 0])


def _frames(hard=True, n=N_FRAMES):
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cam = SimCamera(width=320, height=240, intrinsics=INTR)
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=[cam]),
                    trajectory=circle_trajectory(duration=12.0))
    out = []
    for _ in range(n):
        t, _ = sim.get_next_cam()
        out.append((t, sim.render_image_hard(t) if hard else sim.render_image(t)))
    return cam, out


def _pair(cam, **kw):
    from uvio_tpu.frontend.tracker import KLTTracker as JT

    from uvio_tpu_torch.frontend.tracker import KLTTracker as TT

    kw = dict(num_features=CAP, grid=GRID, **kw)
    return JT(cam.intrinsics, cam.model, **kw), TT(cam.intrinsics, cam.model, device="cpu", **kw)


def _force(jt, tt):
    """The JAX tracker's host state and previous image into the port's."""
    tt.uv, tt.active, tt.ids = jt.uv.copy(), jt.active.copy(), jt.ids.copy()
    tt.next_id = jt.next_id
    prev = np.asarray(jt.prev_img)
    if jt.histeq == "CLAHE":
        # JAX keeps the frame as cv2 equalized it on the host
        from uvio_tpu_torch.frontend.klt import build_pyramid

        tt.prev_img = torch.as_tensor(prev.copy())
        tt.prev_pyr = build_pyramid(tt.prev_img, tt.levels)
    else:
        tt.prev_img, tt.prev_pyr = tt._preprocess(prev)


def _gumbel(key, n):
    return torch.as_tensor(np.array(jax.random.gumbel(key, (64, 8, n), jnp.float32)))


@pytest.fixture(scope="module")
def forced():
    """Per frame k >= 1, from the same forced state: JAX's step outputs
    and the port's, the port's detections under JAX's masks, and both
    trackers' host state after `_spawn`."""
    cam, frames = _frames()
    jt, tt = _pair(cam)
    t0, img0 = frames[0]
    first = (jt.feed(t0, img0), tt.feed(t0, img0))
    rows = []
    for t, img in frames[1:]:
        _force(jt, tt)
        _, sub = jax.random.split(jt._key)  # the key `jt.feed` is about to use
        uv_j, tracked_j, det_uv_j, det_ok_j = (np.asarray(x) for x in jt._jit_step(
            jt.prev_img, jnp.asarray(img, jnp.float32), jnp.asarray(jt.uv), jnp.asarray(jt.active),
            jt.intrinsics, sub, jt.ransac_thresh))
        # LK's own mask, which the step does not return
        from uvio_tpu.frontend.klt import build_pyramid, hist_equalize, lk_track

        pj = [build_pyramid(hist_equalize(x), jt.levels) for x in (jt.prev_img, jnp.asarray(img, jnp.float32))]
        _, ok_j = lk_track(pj[0], pj[1], jnp.asarray(jt.uv), jnp.asarray(jt.active), half=jt.half)
        active = jt.active.copy()

        g = _gumbel(sub, CAP)
        img_d, pyr = tt._preprocess(img)
        uv_d, active_d = tt._table()
        uv_t, ok_t, tracked_t = tt._track(pyr, uv_d, active_d, g)
        det_uv_t, det_ok_t = tt._detect(img_d, torch.tensor(uv_j), torch.tensor(tracked_j))

        # `_spawn` and `_emit` on JAX's arrays
        tt.uv, tt.active = uv_j.copy(), tracked_j.copy()
        tt.ids[~tt.active] = -1
        tt._spawn(det_uv_j, det_ok_j)
        spawned = (tt.ids.copy(), tt.uv.copy(), tt.active.copy(), tt.next_id, tt._emit())

        # and the port's whole `feed` from the same forced state
        _force(jt, tt)
        fed = tt.feed(t, img, gumbel=g)
        fed_state = (tt.ids.copy(), tt.active.copy())

        out_j = jt.feed(t, img)
        rows.append(dict(
            active=active, uv_j=uv_j, ok_j=np.asarray(ok_j), tracked_j=tracked_j,
            det_uv_j=det_uv_j, det_ok_j=det_ok_j, uv_t=uv_t.numpy(), ok_t=ok_t.numpy(),
            tracked_t=tracked_t.numpy(), det_uv_t=det_uv_t.numpy(), det_ok_t=det_ok_t.numpy(),
            spawned=spawned, jax_after=(jt.ids.copy(), jt.uv.copy(), jt.active.copy(), jt.next_id, out_j),
            fed=fed, fed_state=fed_state,
        ))
    return first, rows


def test_first_frame_detection_equal(forced):
    (ids_j, uv_j), (ids_t, uv_t) = forced[0]
    assert len(ids_j) >= 30
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(uv_t, uv_j)


def test_teacher_forced_lk(forced):
    """LK from the same state: masks equal on >= 99% of active slots,
    positions within 1e-3 px where both keep the track."""
    n_act = n_eq = 0
    worst = 0.0
    for r in forced[1]:
        a = r["active"]
        n_act += a.sum()
        n_eq += (r["ok_j"][a] == r["ok_t"][a]).sum()
        both = a & r["ok_j"] & r["ok_t"]
        assert both.sum() >= 15
        worst = max(worst, float(np.abs(r["uv_j"][both] - r["uv_t"][both]).max()))
    assert n_act >= 40 * len(forced[1])
    assert n_eq >= 0.99 * n_act, (n_eq, n_act)
    assert worst <= 1e-3, worst


def test_teacher_forced_tracked(forced):
    """LK and RANSAC with JAX's noise: `tracked` equal on >= 97% of slots."""
    n = sum(len(r["tracked_j"]) for r in forced[1])
    eq = sum((r["tracked_j"] == r["tracked_t"]).sum() for r in forced[1])
    assert eq >= 0.97 * n, (eq, n)
    assert sum(r["tracked_t"].sum() for r in forced[1]) >= 20 * len(forced[1])


def test_teacher_forced_detection_exact(forced):
    """FAST-9 + grid detection with JAX's positions and `tracked` as the
    occupancy: the same corners, exactly."""
    for r in forced[1]:
        np.testing.assert_array_equal(r["det_ok_t"], r["det_ok_j"])
        np.testing.assert_array_equal(r["det_uv_t"][r["det_ok_t"]], r["det_uv_j"][r["det_ok_j"]])
    assert sum(r["det_ok_t"].sum() for r in forced[1]) > 0


def test_spawn_and_emit_equal(forced):
    for r in forced[1]:
        ids, uv, active, next_id, (e_ids, e_uv) = r["spawned"]
        j_ids, j_uv, j_active, j_next, (je_ids, je_uv) = r["jax_after"]
        np.testing.assert_array_equal(active, j_active)
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(uv[active], j_uv[j_active])
        assert next_id == j_next
        np.testing.assert_array_equal(e_ids, je_ids)
        np.testing.assert_array_equal(e_uv, je_uv)


def test_feed_from_forced_state(forced):
    """The port's whole `feed` (one read-back, cached pyramid) from JAX's
    state: the ids it emits are JAX's on >= 95% of the slots."""
    n = eq = 0
    for r in forced[1]:
        ids_t, active_t = r["fed_state"]
        ids_j, _, active_j, _, _ = r["jax_after"]
        n += len(ids_j)
        eq += ((ids_t == ids_j) & (active_t == active_j)).sum()
        assert len(r["fed"][0]) == active_t.sum()
    assert eq >= 0.95 * n, (eq, n)


def test_free_running_gates():
    """The port alone on 12 plain rendered frames: the gates of
    `test_tracker_on_rendered_sim`."""
    from uvio_tpu_torch.frontend.tracker import KLTTracker

    cam, frames = _frames(hard=False)
    tracker = KLTTracker(cam.intrinsics, cam.model, num_features=CAP, grid=GRID, device="cpu")
    lengths, prev, drifts = {}, {}, []
    for i, (t, img) in enumerate(frames):
        ids, uvs = tracker.feed(t, img)
        assert len(ids) >= 20, f"frame {i}: too few tracks ({len(ids)})"
        assert ids.dtype == np.int64 and uvs.dtype == np.float32 and uvs.shape == (len(ids), 2)
        for fid, uv in zip(ids, uvs):
            lengths[fid] = lengths.get(fid, 0) + 1
            if fid in prev:
                drifts.append(np.linalg.norm(uv - prev[fid]))
            prev[fid] = uv
    assert max(lengths.values()) >= 8
    assert np.median(drifts) < 30.0


def test_tracker_refills_after_mass_loss():
    """After wiping every track, one frame refills the tracker to (near)
    capacity (`tests/test_frontend.py::test_tracker_refills_after_mass_loss`)."""
    from uvio_tpu_torch.frontend.tracker import KLTTracker

    rng = np.random.default_rng(3)
    H, W = 240, 320
    img = np.full((H, W), 60.0, np.float32)
    for y0 in range(8, H - 8, 7):
        for x0 in range(8, W - 8, 7):
            img[y0 + int(rng.integers(-2, 3)), x0 + int(rng.integers(-2, 3))] = 230.0
    intr = np.array([200.0, 200.0, W / 2, H / 2, 0, 0, 0, 0])
    tr = KLTTracker(intr, num_features=120, grid=(5, 6), histeq="NONE", device="cpu")
    assert tr.per_cell >= 4
    tr.feed(0.0, img)
    full = int(tr.active.sum())
    assert full >= 2 * 5 * 6, full
    tr.feed(0.1, img)
    tr.active[:] = False
    tr.ids[:] = -1
    tr.feed(0.2, img)
    refilled = int(tr.active.sum())
    assert refilled >= 0.8 * full, (refilled, full)


def test_eager_steps_keep_the_timing_row():
    """A tracker whose graphed steps are swapped for their plain bodies
    (`.eager`, as the card's graph-against-eager tests do) still writes its
    timing row, with no capture time."""
    from uvio_tpu_torch.frontend.tracker import KLTTracker

    H, W = 120, 160
    img = np.full((H, W), 60.0, np.float32)
    img[8:H - 8:9, 8:W - 8:9] = 230.0
    tr = KLTTracker(np.array([100.0, 100.0, W / 2, H / 2, 0, 0, 0, 0]), num_features=40, grid=(3, 4),
                    histeq="NONE", device="cpu")
    tr.step_first, tr.step_track = tr.step_first.eager, tr.step_track.eager
    for k in range(2):
        tr.feed(0.1 * k, img)
        assert tr.last_timing["capture_ms"] == 0.0 and tr.last_timing["track"] > 0.0


@pytest.mark.parametrize("num_features,grid", [(150, (8, 10)), (120, (5, 6)), (10, (6, 8)), (400, (6, 8))])
def test_per_cell_rule(num_features, grid):
    cam, _ = _frames(n=0)
    from uvio_tpu.frontend.tracker import KLTTracker as JT

    from uvio_tpu_torch.frontend.tracker import KLTTracker as TT

    a = JT(cam.intrinsics, num_features=num_features, grid=grid)
    b = TT(cam.intrinsics, num_features=num_features, grid=grid, device="cpu")
    assert a.per_cell == b.per_cell
    assert a.ransac_thresh == b.ransac_thresh


def test_level_reduction_small_image():
    """A 40x60 image cannot hold 4 levels of 15x15 windows: the same
    reduced level count as JAX's, and the port tracks at it."""
    cam, _ = _frames(n=0)
    jt, tt = _pair(cam)
    jt._build_step((40, 60))
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    tt.feed(0.0, img)
    assert tt.levels == jt.levels == 2
    assert len(tt.prev_pyr) == 2
    ids, uvs = tt.feed(0.1, np.roll(img, 1, axis=1))
    assert len(ids) == len(uvs)


@pytest.mark.parametrize("window_half", [5, 7])
def test_window_half_passes_through(window_half):
    """`window_half` reaches LK: the port's `tracked` under JAX's noise
    equals JAX's on >= 97% of slots for another window than 15x15."""
    cam, frames = _frames(n=3)
    jt, tt = _pair(cam, window_half=window_half)
    n = eq = 0
    for k, (t, img) in enumerate(frames):
        if k:
            _force(jt, tt)
            _, sub = jax.random.split(jt._key)
            tt.feed(t, img, gumbel=_gumbel(sub, CAP))
            fed_active = tt.active.copy()
        else:
            tt.feed(t, img)
        jt.feed(t, img)
        if k:
            n += CAP
            eq += (fed_active == jt.active).sum()
    assert tt.half == window_half
    assert eq >= 0.97 * n, (eq, n)


@pytest.mark.parametrize("histeq", ["NONE", "HISTOGRAM", "CLAHE"])
def test_histeq_modes(histeq):
    """Each preprocessing mode: the first frame's detections are JAX's
    exactly, and after two teacher-forced frames the emitted ids agree on
    >= 90% of slots."""
    if histeq == "CLAHE":
        pytest.importorskip("cv2")
    cam, frames = _frames(n=3)
    jt, tt = _pair(cam, histeq=histeq)
    for k, (t, img) in enumerate(frames):
        if k == 0:
            (ids_j, uv_j), (ids_t, uv_t) = jt.feed(t, img), tt.feed(t, img)
            np.testing.assert_array_equal(ids_t, ids_j)
            np.testing.assert_array_equal(uv_t, uv_j)
            assert len(ids_t) >= 20
            continue
        _force(jt, tt)
        _, sub = jax.random.split(jt._key)
        tt.feed(t, img, gumbel=_gumbel(sub, CAP))
        jt.feed(t, img)
        same = (tt.ids == jt.ids) & (tt.active == jt.active)
        assert same.mean() >= 0.9, (histeq, k, same.mean())


def test_generator_is_explicit_and_seeded():
    """Two trackers built alike draw the same RANSAC noise; a generator
    handed in is the one used."""
    from uvio_tpu_torch.frontend.tracker import KLTTracker

    cam, frames = _frames(n=3)
    a = KLTTracker(cam.intrinsics, num_features=CAP, grid=GRID, device="cpu")
    g = torch.Generator().manual_seed(0)
    b = KLTTracker(cam.intrinsics, num_features=CAP, grid=GRID, device="cpu", generator=g)
    assert b.generator is g
    for t, img in frames:
        (ia, ua), (ib, ub) = a.feed(t, img), b.feed(t, img)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ua, ub)


def test_default_device_is_the_card():
    """No `device` means cuda:0, or an error where there is none."""
    from uvio_tpu_torch.frontend.descriptor import DescriptorTracker
    from uvio_tpu_torch.frontend.stereo import StereoKLTTracker
    from uvio_tpu_torch.frontend.tracker import KLTTracker

    if torch.cuda.is_available():
        assert KLTTracker(INTR).device == torch.device("cuda:0")
        return
    for make in (lambda: KLTTracker(INTR), lambda: StereoKLTTracker(INTR, INTR),
                 lambda: DescriptorTracker(INTR)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_port_imports_no_jax():
    """No module of the port, and not `chip_smoke.py`, imports jax, flax
    or `uvio_tpu`."""
    import os
    import re

    root = os.path.join(os.path.dirname(__file__), "..")
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "uvio_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|uvio_tpu)(\.|\s|$)", re.M)
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
    assert len(files) > 40

"""Port parity, the descriptor tracker: steered BRIEF words and Hamming
matching of `uvio_tpu_torch.frontend.descriptor` against `uvio_tpu`'s.

`describe`: the same `ok`, >= 99.5% of the 256 x N bits equal (a bit
compares two float32 bilinear samples and may flip where they are equal
to rounding). `hamming_match` works on integers and is held exactly,
ties included (lowest index, `jnp.argmin`'s rule). The tracker is held
teacher-forced: before each frame the JAX tracker's previous frame goes
into the port's, and RANSAC gets JAX's Gumbel noise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvio_tpu.frontend import descriptor as JD

from uvio_tpu_torch.frontend import descriptor as TD

torch.set_num_threads(1)

INTR = np.array([195.0, 195.0, 156.0, 124.0, 0, 0, 0, 0])


def _words(desc):
    return desc.numpy().astype(np.uint32)


def _bits_of(words):
    return (np.asarray(words, np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1


def textured_image(H=160, W=200, shift=(0, 0), seed=4):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 4 + 8, W // 4 + 8)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4), np.float32))
    up = np.roll(up, (int(shift[1]), int(shift[0])), axis=(0, 1))
    return up[:H, :W]


def test_constants_bit_equal():
    np.testing.assert_array_equal(TD._PATTERN, np.asarray(JD._PATTERN))
    np.testing.assert_array_equal(TD._DISK, np.asarray(JD._DISK))
    assert TD._PATTERN.dtype == np.float32 and TD._PATTERN.shape == (256, 2, 2)


def test_smooth_matches():
    img = np.random.default_rng(0).uniform(0, 255, (50, 70)).astype(np.float32)
    a = np.asarray(JD._smooth(jnp.asarray(img)))
    b = TD._smooth(torch.as_tensor(img)).numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("oriented", [True, False])
def test_describe_matches(oriented):
    """200 points, some at the border and some invalid, on a smoothed
    random texture and on a rendered frame."""
    from scipy.ndimage import gaussian_filter

    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    rng = np.random.default_rng(5)
    tex = (gaussian_filter(rng.uniform(0, 255, (240, 320)), 2.0) * 4).astype(np.float32)
    sim = Simulator(SimParams(num_pts=60, seed=3, cameras=[SimCamera(width=320, height=240, intrinsics=INTR)]),
                    trajectory=circle_trajectory(duration=6.0))
    for img in (tex, sim.render_image(sim.t_start + 0.5)):
        uv = rng.uniform([-5, -5], [325, 245], (200, 2)).astype(np.float32)
        uv[:40] = np.round(uv[:40])  # integer pixels, as the detector gives
        valid = rng.uniform(size=200) < 0.9
        d_j, ok_j = JD.describe(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(valid), oriented=oriented)
        d_t, ok_t = TD.describe(torch.as_tensor(img), torch.as_tensor(uv), torch.as_tensor(valid),
                                oriented=oriented)
        assert d_t.shape == (200, 8) and d_t.dtype == torch.int64
        assert int(d_t.min()) >= 0 and int(d_t.max()) < 2**32
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        ok = ok_t.numpy()
        assert 60 < ok.sum() < 200
        same = _bits_of(_words(d_t))[ok] == _bits_of(np.asarray(d_j))[ok]
        assert same.mean() >= 0.995, same.mean()


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (17, 256)).astype(bool)
    words = TD._pack(torch.as_tensor(bits))
    # the packing of `uvio_tpu`: bit k of word w is bit 32 w + k
    ref = (bits.reshape(17, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    np.testing.assert_array_equal(words.numpy().astype(np.uint64), ref)
    np.testing.assert_array_equal(TD._unpack(words).numpy().astype(bool), bits)


def _match_both(d1, v1, d2, v2, ratio=0.75):
    a = np.asarray(JD.hamming_match(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2), ratio=ratio))
    b = TD.hamming_match(torch.as_tensor(d1.astype(np.int64)), torch.tensor(v1),
                         torch.as_tensor(d2.astype(np.int64)), torch.tensor(v2), ratio=ratio).numpy()
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hamming_match_exact_random(seed):
    """Random words, and noisy copies of them so that real matches exist."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (48, 8), dtype=np.uint64).astype(np.uint32)
    flips = (rng.uniform(size=(48, 8, 32)) < 0.08).astype(np.uint32)
    noise = (flips << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)
    d2 = (d1 ^ noise)[rng.permutation(48)][:40]
    v1, v2 = rng.uniform(size=48) < 0.9, rng.uniform(size=40) < 0.9
    a, b = _match_both(d1, v1, d2, v2)
    np.testing.assert_array_equal(b, a)
    assert (b >= 0).sum() >= 20
    a, b = _match_both(d1, v1, d2, v2, ratio=0.98)  # a loose ratio: symmetry decides
    np.testing.assert_array_equal(b, a)


def test_hamming_match_exact_on_jax_descriptors():
    img, img2 = textured_image(), textured_image(shift=(4, -3))
    rng = np.random.default_rng(2)
    uv = rng.uniform([30, 30], [170, 130], (40, 2)).astype(np.float32)
    d1, ok1 = JD.describe(jnp.asarray(img), jnp.asarray(uv), jnp.ones(40, bool))
    d2, ok2 = JD.describe(jnp.asarray(img2), jnp.asarray(uv + np.float32([4, -3])), jnp.ones(40, bool))
    a, b = _match_both(np.asarray(d1), np.asarray(ok1), np.asarray(d2), np.asarray(ok2))
    np.testing.assert_array_equal(b, a)
    assert (b == np.arange(40)).sum() >= 30


def test_hamming_match_ties():
    """Constructed ties: rows of d2 at the same distance from a row of d1
    (the lowest index wins in both directions), duplicates, an all-invalid
    side and a single candidate."""
    z = np.zeros((1, 8), np.uint32)
    one = lambda *bits: np.array([[sum(1 << b for b in bits)] + [0] * 7], np.uint32)
    # d1[0] = 0; d2 holds three words at distance 1 and one at distance 3
    d1 = np.concatenate([z, one(0, 1, 2, 3, 4, 5, 6, 7)])
    d2 = np.concatenate([one(9), one(10), one(11), one(0, 1, 2)])
    for ratio in (0.75, 1.5):
        a, b = _match_both(d1, np.ones(2, bool), d2, np.ones(4, bool), ratio=ratio)
        np.testing.assert_array_equal(b, a)
    assert b[0] == 0  # the tie of three goes to index 0 (second best equal: only ratio > 1 passes)
    # duplicates on both sides: the mutual check pairs the first of each
    d = np.concatenate([one(3), one(3), one(20, 21)])
    e = np.concatenate([one(3, 4), one(3, 4), one(20, 21)])
    a, b = _match_both(d, np.ones(3, bool), e, np.ones(3, bool), ratio=1.5)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(b, [0, -1, 2])
    # invalid sides and a single candidate
    for v1, v2 in ((np.zeros(3, bool), np.ones(3, bool)), (np.ones(3, bool), np.zeros(3, bool)),
                   (np.ones(3, bool), np.array([False, True, False]))):
        a, b = _match_both(d, v1, d, v2)
        np.testing.assert_array_equal(b, a)


def test_first_argmin_is_lowest_index():
    dist = torch.tensor([[5, 2, 2, 7], [1, 1, 1, 1], [9, 8, 7, 7]])
    v, i = TD._first_argmin(dist, 1)
    assert v.tolist() == [2, 1, 7] and i.tolist() == [1, 0, 2]
    v, i = TD._first_argmin(dist, 0)
    assert v.tolist() == [1, 1, 1, 1] and i.tolist() == [1, 1, 1, 1]


def test_descriptor_matching():
    """`tests/test_frontend.py::test_descriptor_matching` through the port."""
    img = textured_image()
    uv = torch.tensor([(60.0, 60.0), (140.0, 100.0), (90.0, 40.0)], dtype=torch.float64)
    ones = torch.ones(3, dtype=torch.bool)
    d1, ok1 = TD.describe(torch.as_tensor(img), uv, ones)
    assert bool(ok1.all())
    img2 = textured_image(shift=(4, -3))
    d2, ok2 = TD.describe(torch.as_tensor(img2), uv + torch.tensor([4.0, -3.0], dtype=torch.float64), ones)
    m = TD.hamming_match(d1, ok1, d2, ok2)
    np.testing.assert_array_equal(m.numpy(), [0, 1, 2])


def test_descriptor_rotation_invariance():
    """`tests/test_frontend.py::test_descriptor_rotation_invariance` through
    the port: steered BRIEF survives 30-45 deg in-plane rotation where the
    unsteered variant loses the match."""
    from scipy.ndimage import gaussian_filter
    from scipy.ndimage import rotate as nd_rotate

    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (200, 200)).astype(np.float32)
    img = gaussian_filter(img, 2.0) * 4
    c = np.array([100.0, 100.0])
    pts_src = np.array([[100.0, 100.0], [80.0, 120.0], [126.0, 88.0]])
    ones = torch.ones(3, dtype=torch.bool)
    for deg in (30.0, 45.0):
        rot = nd_rotate(img, deg, reshape=False, order=1)
        th = np.radians(deg)
        R = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
        pts_dst = (pts_src - c) @ R.T + c
        args1 = (torch.as_tensor(img), torch.as_tensor(pts_src), ones)
        args2 = (torch.as_tensor(rot), torch.as_tensor(pts_dst), ones)
        d1o, ok1 = TD.describe(*args1)
        d2o, ok2 = TD.describe(*args2)
        assert bool(ok1.all()) and bool(ok2.all())
        m_o = TD.hamming_match(d1o, ok1, d2o, ok2).numpy()
        d1u, _ = TD.describe(*args1, oriented=False)
        d2u, _ = TD.describe(*args2, oriented=False)
        m_u = TD.hamming_match(d1u, ok1, d2u, ok2).numpy()
        n_o = (m_o == np.arange(3)).sum()
        n_u = (m_u == np.arange(3)).sum()
        assert n_o >= 2, (deg, m_o)
        assert n_o > n_u, (deg, m_o, m_u)
        # and the same matches as `uvio_tpu` on the same inputs
        j = [JD.describe(jnp.asarray(np.asarray(a[0])), jnp.asarray(np.asarray(a[1])), jnp.ones(3, bool))
             for a in (args1, args2)]
        np.testing.assert_array_equal(np.asarray(JD.hamming_match(j[0][0], j[0][1], j[1][0], j[1][1])), m_o)


def test_detect_leaves_cell_zero_free():
    """`_detect` passes one inactive point at (0, 0) as the occupancy: the
    corner cell stays free, as in `uvio_tpu`."""
    from uvio_tpu_torch.frontend.klt import grid_detect

    score = torch.zeros((32, 32))
    score[4, 4] = 10.0
    score[20, 24] = 5.0
    uv, ok = grid_detect(score, 2, 2, torch.zeros((1, 2)), torch.zeros(1, dtype=torch.bool))
    got = {tuple(map(int, p)) for p in uv[ok].tolist()}
    assert got == {(4, 4), (24, 20)}
    uv2, ok2 = grid_detect(score, 2, 2, torch.zeros((1, 2)), torch.ones(1, dtype=torch.bool))
    assert {tuple(map(int, p)) for p in uv2[ok2].tolist()} == {(24, 20)}


@pytest.fixture(scope="module")
def tracker_run():
    """6 rendered frames through both trackers, the port's previous frame
    forced to JAX's before each and RANSAC fed JAX's noise."""
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cam = SimCamera(width=320, height=240, intrinsics=INTR)
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=[cam]),
                    trajectory=circle_trajectory(duration=10.0))
    jt = JD.DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8))
    tt = TD.DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8), device="cpu")
    rows = []
    for k in range(6):
        t, _ = sim.get_next_cam()
        img = sim.render_image(t)
        gumbel = None
        if jt.prev is not None:
            p_uv, p_desc, p_valid, p_ids = jt.prev
            tt.prev = (np.asarray(p_uv).copy(), torch.as_tensor(np.asarray(p_desc).astype(np.int64)),
                       torch.tensor(np.asarray(p_valid)), p_ids.copy())
            tt.next_id = jt.next_id
            # the pairs JAX will hand to RANSAC, for the noise's shape
            uv_j, desc_j, valid_j = jt._jit_detect(jnp.asarray(img, jnp.float32))
            m = np.asarray(jt._jit_match(p_desc, p_valid, desc_j, valid_j))
            n_pairs = int((m >= 0).sum())
            if n_pairs >= 12:
                _, sub = jax.random.split(jt._key)
                gumbel = torch.as_tensor(np.array(jax.random.gumbel(sub, (64, 8, n_pairs), jnp.float32)))
        out_j = jt.feed(t, img)
        out_t = tt.feed(t, img, gumbel=gumbel)
        rows.append((out_j, out_t, jt.prev, tt.prev, jt.next_id, tt.next_id))
    return rows


def test_descriptor_tracker_detections_equal(tracker_run):
    for (_, _, jp, tp, _, _) in tracker_run:
        np.testing.assert_array_equal(tp[0], np.asarray(jp[0]))  # corners
        np.testing.assert_array_equal(tp[2].numpy(), np.asarray(jp[2]))  # valid
        ok = tp[2].numpy()
        same = _bits_of(_words(tp[1]))[ok] == _bits_of(np.asarray(jp[1]))[ok]
        assert same.mean() >= 0.995


def test_descriptor_tracker_ids_teacher_forced(tracker_run):
    """Ids equal on >= 95% of the corners over the 6 frames, >= 15 tracks
    a frame, and tracks that persist."""
    n = eq = 0
    lengths = {}
    for (ids_j, uv_j), (ids_t, uv_t), jp, tp, _, _ in tracker_run:
        assert len(ids_t) >= 15
        n += len(jp[3])
        eq += (jp[3] == tp[3]).sum()
        for fid in ids_t:
            lengths[fid] = lengths.get(fid, 0) + 1
    assert eq >= 0.95 * n, (eq, n)
    assert max(lengths.values()) >= 5


def test_descriptor_tracker_free_running():
    """The gates of `test_descriptor_tracker_on_rendered_sim` at the reduced
    size: >= 15 tracks a frame, one track of length >= 6 over 8 frames."""
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cam = SimCamera(width=320, height=240, intrinsics=INTR)
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=[cam]),
                    trajectory=circle_trajectory(duration=10.0))
    tracker = TD.DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8), device="cpu")
    lengths = {}
    for i in range(8):
        t, _ = sim.get_next_cam()
        ids, uvs = tracker.feed(t, sim.render_image(t))
        assert len(ids) >= 15, f"frame {i}: {len(ids)} tracks"
        assert ids.dtype == np.int64 and uvs.shape == (len(ids), 2) and len(set(ids)) == len(ids)
        for fid in ids:
            lengths[fid] = lengths.get(fid, 0) + 1
    assert max(lengths.values()) >= 6

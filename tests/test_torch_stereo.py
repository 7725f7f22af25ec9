"""Port parity, stereo KLT: `stereo_match` against `uvio_tpu`'s on a
rendered stereo pair (320x240, intrinsics scaled, baseline 0.11 m), and
the free-running `StereoKLTTracker` against the gates of
`tests/test_frontend.py::test_stereo_klt_on_rendered_sim`."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

INTR = np.array([195.0, 195.0, 156.0, 124.0, 0, 0, 0, 0])


@pytest.fixture(scope="module")
def rig():
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cams = [SimCamera(width=320, height=240, intrinsics=INTR),
            SimCamera(width=320, height=240, intrinsics=INTR, p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=cams),
                    trajectory=circle_trajectory(duration=10.0))
    frames = []
    for _ in range(5):
        t, _ = sim.get_next_cam()
        frames.append((t, sim.render_image(t, cam_idx=0), sim.render_image(t, cam_idx=1)))
    return cams, frames


@pytest.mark.parametrize("histeq", ["HISTOGRAM", "NONE"])
def test_stereo_match_matches(rig, histeq):
    """Left features into the right image: masks equal on >= 99%,
    positions within 1e-3 px, with and without the left pyramid handed in."""
    from uvio_tpu.frontend.tracker import KLTTracker as JT

    from uvio_tpu_torch.frontend.tracker import KLTTracker as TT

    cams, frames = rig
    kw = dict(num_features=60, grid=(6, 8), histeq=histeq)
    jt, tt = JT(INTR, cams[0].model, **kw), TT(INTR, cams[0].model, device="cpu", **kw)
    t, left, right = frames[1]
    jt.feed(t, left)
    tt.feed(t, left)
    np.testing.assert_array_equal(tt.uv, jt.uv)
    uv = jt.uv[jt.active]
    valid = np.ones(len(uv), bool)
    valid[::9] = False
    uv_j, ok_j = jt.stereo_match(left, right, uv, valid)
    for pyr_left in (None, tt.prev_pyr):
        uv_t, ok_t = tt.stereo_match(left, right, uv, valid, pyr_left=pyr_left)
        assert uv_t.dtype == np.float32 and ok_t.dtype == bool
        assert (ok_t == ok_j).mean() >= 0.99
        assert not ok_t[::9].any()
        both = ok_t & ok_j
        assert both.sum() >= 20
        assert np.abs(uv_t[both] - uv_j[both]).max() <= 1e-3
        # baseline 0.11 m, depth 5-10 m, f = 195: disparity of a few px
        assert 1.0 < np.median(np.abs(uv_t[both, 0] - uv[both, 0])) < 10.0


def test_stereo_tracker_free_running(rig):
    """The gates of `test_stereo_klt_on_rendered_sim` at the reduced size
    (f = 195 px: disparity ~ 2..4 px, bounds scaled with the focal length)."""
    from uvio_tpu_torch.frontend.stereo import StereoKLTTracker

    cams, frames = rig
    tr = StereoKLTTracker(cams[0].intrinsics, cams[1].intrinsics, cams[0].model,
                          num_features=60, grid=(6, 8), device="cpu")
    matched = 0
    for i, (t, left, right) in enumerate(frames):
        (idsL, uvL), (idsR, uvR) = tr.feed(t, left, right)
        assert len(idsL) == len(uvL) and len(idsR) == len(uvR)
        if i == 0:
            continue  # first frame: detection only
        assert len(idsR) >= 10, f"frame {i}: only {len(idsR)} stereo matches"
        assert set(idsR) <= set(idsL)
        mapL = dict(zip(idsL, uvL))
        dus = np.asarray([uvR[j][0] - mapL[idsR[j]][0] for j in range(len(idsR))])
        matched += len(dus)
        assert 2.0 * 195 / 458 < np.median(np.abs(dus)) < 20.0 * 195 / 458, np.median(dus)
    assert matched > 30


def test_stereo_ransac_gate_and_generator(rig):
    """Fewer than 12 matches skip the left<->right RANSAC and draw nothing
    from its generator; with matches it draws, from its own generator."""
    from uvio_tpu_torch.frontend.stereo import StereoKLTTracker

    cams, frames = rig
    tr = StereoKLTTracker(cams[0].intrinsics, cams[1].intrinsics, cams[0].model,
                          num_features=60, grid=(6, 8), device="cpu")
    assert tr.generator is not tr.left.generator
    start = tr.generator.get_state().clone()
    t, left, right = frames[0]
    match = tr.left.stereo_match

    def eleven(*a, **kw):  # LK keeps 11 matches: one short of the gate
        uv_r, ok = match(*a, **kw)
        ok[np.nonzero(ok)[0][11:]] = False
        return uv_r, ok

    tr.left.stereo_match = eleven
    (idsL, _), (idsR, _) = tr.feed(t, left, right)
    tr.left.stereo_match = match
    assert len(idsL) >= 20 and len(idsR) == 11
    assert torch.equal(tr.generator.get_state(), start)
    t, left, right = frames[1]
    (_, _), (idsR, _) = tr.feed(t, left, right)
    assert len(idsR) >= 12
    assert not torch.equal(tr.generator.get_state(), start)


def test_stereo_empty_left(rig):
    """No left track at all: both cameras get the same empty observation."""
    from uvio_tpu_torch.frontend.stereo import StereoKLTTracker

    cams, frames = rig
    tr = StereoKLTTracker(cams[0].intrinsics, cams[1].intrinsics, cams[0].model,
                          num_features=60, grid=(6, 8), device="cpu")
    flat = np.full((240, 320), 40.0, np.float32)
    (idsL, uvL), (idsR, uvR) = tr.feed(0.0, flat, flat)
    assert len(idsL) == len(idsR) == 0 and uvL.shape == uvR.shape == (0, 2)

"""The port's KLT tracker on the card: `KLTTracker.feed` through the CUDA
kernels against the same tracker forced onto the kernels' plain versions,
teacher-forced for 10 hard rendered frames at 752x480 (before each frame
the plain tracker takes the kernel tracker's state, and both get the same
RANSAC noise): FAST-9 bitwise, LK masks equal, positions within 3.4e-4 px
where float32 determines them (on a weak patch the plain version itself
moves by more between float32 and float64), within 0.05 px where float32
determines them to 0.05 px, and on every track no further from the
float64 evaluation than the plain float32 chain is, plus 0.05 px (on a
near-singular coarse level the plain float32 chain can land pixels away
from its own float64 evaluation, and then no float32 order of the sums
is the right one; at most 1% of the tracks may be such), the same
detections, and one launch of each kernel per `feed`. Skips without a
CUDA device.

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tracker_cuda.py
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.frontend import kernels as K
from uvio_tpu_torch.frontend import tracker as T
from uvio_tpu_torch.frontend.klt import gumbel_noise

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda:0")


def _hard_frames(n):
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9),
                    trajectory=circle_trajectory(duration=8.0))
    cam = sim.params.cameras[0]
    out = []
    for _ in range(n):
        t, _ = sim.get_next_cam()
        out.append((t, sim.render_image_hard(t)))
    return cam, out


def test_feed_through_kernels_matches_plain(dev, monkeypatch):
    cam, frames = _hard_frames(12)
    kw = dict(num_features=150, grid=(6, 8), histeq="HISTOGRAM")
    a = T.KLTTracker(cam.intrinsics, cam.model, **kw)  # device=None: the card
    b = T.KLTTracker(cam.intrinsics, cam.model, **kw)
    assert a.device == dev
    gen = torch.Generator(device=dev).manual_seed(3)

    def device_work(tr, img, noise):
        img_d, pyr = tr._preprocess(img)
        uv, active = tr._table()
        score = T.fast_score(img_d, tr.fast_thresh)
        uv_new, ok, tracked = tr._track(pyr, uv, active, noise)
        det_uv, det_ok = tr._detect(img_d, uv_new, tracked)
        return score, uv_new, ok, tracked, det_uv, det_ok, active, (pyr, uv)

    for t, img in frames[:2]:
        a.feed(t, img)
    worst = worst_any = worst_vs_64 = 0.0
    n_both = n_stable = n_undetermined = 0
    for t, img in frames[2:]:
        b.uv, b.active, b.ids, b.next_id = a.uv.copy(), a.active.copy(), a.ids.copy(), a.next_id
        b.prev_img, b.prev_pyr, b.levels = a.prev_img, a.prev_pyr, a.levels
        noise = gumbel_noise((64, 8, a.cap), gen, dev)
        s_k, uv_k, ok_k, tr_k, du_k, dk_k, active, (pyr, uv) = device_work(a, img, noise)
        with monkeypatch.context() as m:
            m.setattr(T, "fast_score", K.fast_score_ref)
            m.setattr(T, "lk_track", K.lk_track_ref)
            before = dict(K.launch_counts)
            s_p, uv_p, ok_p, tr_p, du_p, dk_p, _, _ = device_work(b, img, noise)
            assert K.launch_counts == before  # the plain versions launch no hand kernel
        assert torch.equal(s_k, s_p)  # FAST-9 bitwise
        assert int((s_k > 0).sum()) > 100
        assert torch.equal(ok_k, ok_p)
        both = ok_k & active
        assert int(both.sum()) >= 50
        # float32 determines a position where the plain version in float32
        # lies within 2.5e-4 px of its float64 evaluation
        uv_64, _ = K.lk_track_ref([p.double() for p in a.prev_pyr], [p.double() for p in pyr],
                                  uv.double(), active, half=a.half)
        f32_err = (uv_p.double() - uv_64).abs().amax(1)
        stable = both & (f32_err < 2.5e-4)
        near = both & (f32_err <= 0.05)
        n_both += int(both.sum())
        n_stable += int(stable.sum())
        n_undetermined += int((both & ~near).sum())
        worst = max(worst, float((uv_k[stable] - uv_p[stable]).abs().max()))
        worst_any = max(worst_any, float((uv_k[near] - uv_p[near]).abs().max()))
        # every track: the kernel lies no further from the float64 evaluation
        # than the plain float32 chain does
        k64_err = (uv_k.double() - uv_64).abs().amax(1)
        worst_vs_64 = max(worst_vs_64, float((k64_err - f32_err)[both].max()))
        for i in (both & ~near).nonzero().flatten().tolist():
            print(f"t={t:.2f} track {i}: float32 plain vs float64 {float(f32_err[i]):.4g} px, "
                  f"kernel vs float64 {float(k64_err[i]):.4g} px, "
                  f"kernel vs plain {float((uv_k[i] - uv_p[i]).abs().max()):.4g} px")
        assert torch.equal(dk_k, dk_p) and torch.equal(du_k[dk_k], du_p[dk_p])

        # the whole feed: exactly one launch of each kernel, one packed read-back
        K.reset_launch_counts()
        ids, uvs = a.feed(t, img, gumbel=noise)
        assert K.launch_counts == {"fast9": 1, "lk_track": 1, "lk_level": 0}
        assert not (tr_k.cpu().numpy() & ~a.active).any()  # what was tracked stays active
        assert len(ids) == a.active.sum() >= 50 and uvs.shape == (len(ids), 2)
    assert n_stable >= 0.85 * n_both, (n_stable, n_both)
    assert n_undetermined <= 0.01 * n_both, (n_undetermined, n_both)
    assert worst <= 3.4e-4, worst
    assert worst_any <= 0.05, worst_any  # the rest: weak patches, still the same track
    assert worst_vs_64 <= 0.05, worst_vs_64


@pytest.mark.parametrize("window_half", [5, 7])
def test_window_half_reaches_the_kernel(dev, window_half):
    """`window_half != 7` takes the kernel's generic path: masks equal to
    the plain version's, positions within 1e-3 px."""
    cam, frames = _hard_frames(3)
    tr = T.KLTTracker(cam.intrinsics, cam.model, num_features=150, grid=(6, 8), window_half=window_half)
    for t, img in frames[:2]:
        tr.feed(t, img)
    _, pyr = tr._preprocess(frames[2][1])
    uv, active = tr._table()
    uv_k, ok_k = K.lk_track(tr.prev_pyr, pyr, uv, active, half=window_half)
    uv_p, ok_p = K.lk_track_ref(tr.prev_pyr, pyr, uv, active, half=window_half)
    assert int((ok_k != ok_p).sum()) <= 1
    both = ok_k & ok_p
    assert int(both.sum()) >= 50
    assert float((uv_k[both] - uv_p[both]).abs().max()) <= 1e-3
    with pytest.raises(ValueError):
        K.lk_track(tr.prev_pyr, pyr, uv, active, half=8)  # beyond what the kernel supports


def test_stereo_and_descriptor_launch_counts(dev):
    """`StereoKLTTracker.feed` launches 1 `fast9` and 2 `lk_track`,
    `DescriptorTracker.feed` 1 and 0."""
    from uvio_tpu_torch.frontend.descriptor import DescriptorTracker
    from uvio_tpu_torch.frontend.stereo import StereoKLTTracker
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cams = [SimCamera(), SimCamera(p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=cams),
                    trajectory=circle_trajectory(duration=6.0))
    st = StereoKLTTracker(cams[0].intrinsics, cams[1].intrinsics, cams[0].model, num_features=120, grid=(6, 8))
    de = DescriptorTracker(cams[0].intrinsics, cams[0].model, grid=(6, 8))
    for k in range(3):
        t, _ = sim.get_next_cam()
        left, right = sim.render_image(t, 0), sim.render_image(t, 1)
        K.reset_launch_counts()
        (ids_l, _), (ids_r, _) = st.feed(t, left, right)
        assert K.launch_counts == {"fast9": 1, "lk_track": 2 if k else 1, "lk_level": 0}
        assert len(ids_l) >= 20 and len(ids_r) >= 10
        K.reset_launch_counts()
        ids, _ = de.feed(t, left)
        assert K.launch_counts == {"fast9": 1, "lk_track": 0, "lk_level": 0}
        assert len(ids) >= 15

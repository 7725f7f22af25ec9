"""The port's CUDA kernels against their plain PyTorch versions on the
card. Skips without a CUDA device (the kernels have no CPU mode).

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.frontend import kernels as K
from uvio_tpu_torch.frontend.klt import build_pyramid

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _blobs(seed, H=480, W=752, n=300):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 40.0 + 20.0 * xx / W + 10.0 * yy / H
    for u, v, a in zip(rng.uniform(5, W - 5, n), rng.uniform(5, H - 5, n), rng.uniform(120, 240, n)):
        y0, x0 = int(v) - 5, int(u) - 5
        sl = np.s_[max(y0, 0):y0 + 11, max(x0, 0):x0 + 11]
        img[sl] += a * np.exp(-((xx[sl] - u) ** 2 + (yy[sl] - v) ** 2) / (2 * 1.5**2))
    return np.clip(img, 0, 255).astype(np.float32)


def _fast9_image(name, dev):
    if name == "blobs_480x752":
        return torch.as_tensor(_blobs(0), device=dev)
    H, W = {"random_65x257": (65, 257), "random_40x130": (40, 130), "random_64x256": (64, 256)}[name]
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.rand((H, W), generator=gen, device=dev) * 255.0


@pytest.mark.parametrize("name", ["blobs_480x752", "random_65x257", "random_40x130", "random_64x256"])
def test_fast9_matches_plain(dev, name):
    """Widths that are multiples of 4 take the 16-byte path, 257 and 130
    the scalar one; 65 and 40 rows end inside a tile."""
    img = _fast9_image(name, dev)
    K.reset_launch_counts()
    a = K.fast_score(img, 20.0)
    assert K.launch_counts["fast9"] == 1
    b = K.fast_score_ref(img, 20.0)
    # same ring order, same float32 sums: bitwise
    assert (a - b).abs().max().item() == 0.0
    assert (a > 0).any().item()
    # every corner passes the compass pretest the kernel applies
    assert (K.fast_pretest(img, 20.0) | ~(b > 0)).all().item()


def test_fast9_unaligned_view_takes_the_scalar_path(dev):
    """A contiguous image whose first byte is not 16-byte aligned."""
    buf = torch.as_tensor(_blobs(3, H=64, W=256), device=dev).reshape(-1)
    img = torch.cat([buf.new_zeros(1), buf])[1:].reshape(64, 256)
    assert img.data_ptr() % 16 != 0 and img.is_contiguous()
    assert torch.equal(K.fast_score(img, 20.0), K.fast_score_ref(img, 20.0))


def test_lk_level_matches_plain(dev):
    img1 = _blobs(1)
    img2 = np.roll(img1, (1, 2), axis=(0, 1))  # flow (2, 1)
    p1 = build_pyramid(torch.as_tensor(img1, device=dev), 4)
    p2 = build_pyramid(torch.as_tensor(img2, device=dev), 4)
    rng = np.random.default_rng(1)
    uv = torch.as_tensor(rng.uniform([24, 24], [728, 456], (150, 2)), dtype=torch.float32, device=dev)
    valid = torch.ones(150, dtype=torch.bool, device=dev)
    valid[::10] = False
    for lev in range(4):
        uv_l = (uv / 2.0**lev).contiguous()
        for iters, min_eig in ((10, 25.0), (6, 0.0)):
            args = (p1[lev], p2[lev], uv_l, uv_l, valid, 7, iters, min_eig)
            uv_k, ok_k = K.lk_level(*args)
            uv_r, ok_r = K.lk_level_ref(*args)
            # block sums in another order than the plain version's: a
            # track within rounding of a gate may flip, at most one
            assert (ok_k != ok_r).sum().item() <= 1
            assert not ok_k[~valid].any().item()
            # With min_eig = 0 a patch on the smooth background passes with
            # a near-singular structure tensor; its solve amplifies float32
            # rounding, and the plain version alone moves by up to 0.7 px
            # between float32 and float64 on this scene (measured on the
            # CPU; 13 of 135 tracks by more than 2.5e-4 px at level 0).
            # Compare where float32 determines the answer: the plain
            # version agrees with its float64 evaluation to 2.5e-4 px.
            uv_64, _ = K.lk_level_ref(
                p1[lev].double(), p2[lev].double(), uv_l.double(), uv_l.double(), valid, 7, iters,
                min_eig,
            )
            stable = (uv_r.double() - uv_64).abs().amax(1) < 2.5e-4
            both = ok_k & ok_r
            assert (both & stable).sum().item() >= 0.85 * both.sum().item()
            assert (uv_k[both & stable] - uv_r[both & stable]).abs().max().item() <= 1e-3


def _track_inputs(dev, levels=4):
    img1 = _blobs(1)
    img2 = np.roll(img1, (1, 2), axis=(0, 1))  # flow (2, 1)
    p1 = build_pyramid(torch.as_tensor(img1, device=dev), levels)
    p2 = build_pyramid(torch.as_tensor(img2, device=dev), levels)
    rng = np.random.default_rng(1)
    uv = torch.as_tensor(rng.uniform([24, 24], [728, 456], (150, 2)), dtype=torch.float32, device=dev)
    valid = torch.ones(150, dtype=torch.bool, device=dev)
    valid[::10] = False
    return p1, p2, uv, valid


@pytest.mark.parametrize("levels,kw", [(4, {}), (3, dict(iters=8, coarse_iters=3)), (1, {}),
                                       (4, dict(half=5))])
def test_lk_track_matches_chained_levels(dev, levels, kw):
    """One fused launch equals the chain of one-level launches bit for
    bit (they run the same kernel), and the plain version as closely as
    one level does."""
    p1, p2, uv, valid = _track_inputs(dev, levels)
    K.reset_launch_counts()
    uv_f, ok_f = K.lk_track(p1, p2, uv, valid, **kw)
    assert K.launch_counts == {"fast9": 0, "lk_level": 0, "lk_track": 1, "uwb_update": 0, "slam_init": 0,
                               "msckf_update": 0}
    uv_c, ok_c = K.lk_track_ref(p1, p2, uv, valid, level_fn=K.lk_level, **kw)
    assert K.launch_counts["lk_level"] == levels
    assert torch.equal(uv_f, uv_c) and torch.equal(ok_f, ok_c)
    assert not ok_f[~valid].any().item() and ok_f.sum().item() >= 20
    uv_r, ok_r = K.lk_track_ref(p1, p2, uv, valid, **kw)
    assert (ok_f != ok_r).sum().item() <= 2
    # compare where float32 determines the answer (see
    # test_lk_level_matches_plain): the plain chain agrees with its
    # float64 evaluation to 2.5e-4 px
    uv_64, _ = K.lk_track_ref([p.double() for p in p1], [p.double() for p in p2], uv.double(),
                              valid, **kw)
    stable = (uv_r.double() - uv_64).abs().amax(1) < 2.5e-4
    both = ok_f & ok_r
    assert (both & stable).sum().item() >= 0.85 * both.sum().item()
    assert (uv_f[both & stable] - uv_r[both & stable]).abs().max().item() <= 1e-3


def _smooth_scene(dev):
    """A 200x260 Gaussian-smoothed noise image, a copy moved by (2, -1)
    px, 40 feature positions, and guesses 12 px off on the first 10: on
    ground this smooth LK converges from there, across the slab's edge."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(1)
    img = gaussian_filter(rng.uniform(0, 255, (200, 260)), 8.0)
    img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)
    uv = np.stack([rng.uniform(50, 210, 40), rng.uniform(50, 150, 40)], 1).astype(np.float32)
    guess = uv.copy()
    guess[:10] += np.array([12.0, -12.0], np.float32)
    on = lambda a: torch.as_tensor(a, device=dev)
    return on(img), on(np.roll(img, (-1, 2), axis=(0, 1))), on(uv), on(guess)


def test_lk_track_restages_its_slab(dev):
    """Guesses 12 px off (through `lk_level`, which takes a guess): the
    windows leave the staged slab, the kernel stages again and still
    equals the plain version, whose slab variant counts the stagings.
    Then a flow of (96, -80) px through the fused launch, which restages
    at every level and still equals the chained launches bit for bit."""
    img, moved, uv, guess = _smooth_scene(dev)
    args = (img, moved, uv, guess, torch.ones(40, dtype=torch.bool, device=dev), 7, 20, 25.0)
    uv_k, ok_k = K.lk_level(*args)
    uv_r, ok_r, stagings = K.lk_level_slab_ref(*args)
    restaged = stagings >= 2
    assert restaged[:10].sum().item() >= 5 and not restaged[10:].any().item()
    assert (ok_k != ok_r).sum().item() <= 1
    assert torch.isfinite(uv_k).all().item()
    # every feature both keep and that settled on the flow, moved or not
    flow = torch.tensor([2.0, -1.0], device=dev)
    settled = ok_k & ok_r & ((uv_r - uv - flow).abs().amax(1) < 0.05)
    assert (settled & restaged).sum().item() >= 5 and settled[10:].all().item()
    assert (uv_k[settled] - uv_r[settled]).abs().max().item() <= 1e-3

    p1, _, uv0, valid = _track_inputs(dev)
    far = build_pyramid(torch.roll(p1[0], (-80, 96), (0, 1)), 4)
    per_level = []

    def slab_level(*level_args):
        uv_l, ok_l, n = K.lk_level_slab_ref(*level_args)
        per_level.append(int((n >= 2).sum().item()))
        return uv_l, ok_l

    K.lk_track_ref(p1, far, uv0, valid, level_fn=slab_level)
    assert sum(per_level) >= 10  # the plain chain leaves its slabs on this pair
    uv_f, ok_f = K.lk_track(p1, far, uv0, valid)
    uv_c, ok_c = K.lk_track_ref(p1, far, uv0, valid, level_fn=K.lk_level)
    assert torch.equal(uv_f, uv_c) and torch.equal(ok_f, ok_c)

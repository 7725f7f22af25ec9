"""Port parity, vision frontend: histogram equalization, pyramid, the
plain versions of the CUDA kernels (FAST-9, LK) against
`uvio_tpu`'s XLA path and its Pallas kernels in interpret mode, pyramidal
LK, grid detection and RANSAC fed JAX's own Gumbel noise.

On the CPU the kernel wrappers take their plain versions; the kernels
themselves are compared with those on the card by
`test_torch_kernels_cuda.py` and `chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uvio_tpu.frontend import klt as JK
from uvio_tpu.frontend.pallas_kernels import fast_score_pallas, lk_level_pallas

from uvio_tpu_torch.frontend import kernels as TKer
from uvio_tpu_torch.frontend import klt as TK

torch.set_num_threads(1)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _render_like(seed=0, H=120, W=160):
    """Smooth background with Gaussian blobs, like the simulator's frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 40.0 + 20.0 * xx / W + 10.0 * yy / H
    for u, v, a in zip(rng.uniform(5, W - 5, 60), rng.uniform(5, H - 5, 60), rng.uniform(120, 240, 60)):
        img += a * np.exp(-((xx - u) ** 2 + (yy - v) ** 2) / (2 * 1.5**2))
    return np.clip(img, 0, 255).astype(np.float32)


def test_hist_equalize_exact():
    for img in (_render_like(1), np.random.default_rng(2).uniform(0, 255, (60, 90)).astype(np.float32)):
        a = np.asarray(JK.hist_equalize(jnp.asarray(img)))
        b = TK.hist_equalize(_t(img)).numpy()
        np.testing.assert_array_equal(a, b)


def test_build_pyramid_matches():
    img = np.random.default_rng(3).uniform(0, 255, (121, 163)).astype(np.float32)
    pa = JK.build_pyramid(jnp.asarray(img), 4)
    pb = TK.build_pyramid(_t(img), 4)
    for a, b in zip(pa, pb):
        assert a.shape == tuple(b.shape)
        # 2x2 sums in another order: float32 rounding, relative 1e-5
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 96), (100, 130), (128, 128), (480, 752), (65, 257)])
def test_fast_score_ref_matches(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = TKer.fast_score_ref(_t(img), 20.0).numpy()
    xla = np.asarray(JK.fast_score(jnp.asarray(img), 20.0))
    pal = np.asarray(fast_score_pallas(jnp.asarray(img), 20.0, interpret=True))
    # same ring-order accumulation in all three: float32 rounding only
    assert np.abs(ref - xla).max() < 1e-4
    assert np.abs(ref - pal).max() < 1e-4
    assert (ref > 0).sum() > 0


def test_fast9_source_ring_order():
    """The CUDA kernel visits the ring in `_CIRCLE` order: the score is
    a float32 sum, and another order rounds differently."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(TKer.__file__), "..", "csrc", "fast9.cu")).read()
    table = lambda n: [int(v) for v in re.search(n + r"\[16\] = \{([^}]*)\}", src).group(1).split(",")]
    assert list(zip(table("c_ring_dy"), table("c_ring_dx"))) == TKer._CIRCLE == JK._CIRCLE


def test_fast_score_threshold_and_wrapper_route():
    img = np.zeros((32, 128), np.float32)
    img[16, 64] = 200.0  # isolated bright pixel: ring all darker
    before = dict(TKer.launch_counts)
    out = TKer.fast_score(_t(img), 20.0)  # CPU tensor -> plain version
    assert out[16, 64] > 0
    assert TKer.fast_score(_t(img), 250.0)[16, 64] == 0
    assert TKer.launch_counts == before  # no kernel launched on the CPU
    with pytest.raises(ValueError):
        TKer.fast_score(_t(img).to("meta"), 20.0)


def _lk_scene(seed=0, H=120, W=160, N=32, shift=(2, -1)):
    from scipy.signal import convolve2d

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (H // 4 + 4, W // 4 + 4))
    img1 = np.kron(base, np.ones((4, 4)))[:H, :W]
    img1 = convolve2d(img1, np.ones((3, 3)) / 9, mode="same")
    img2 = np.roll(img1, (shift[1], shift[0]), axis=(0, 1))
    uv = np.stack([rng.uniform(20, W - 20, N), rng.uniform(20, H - 20, N)], 1)
    return img1.astype(np.float32), img2.astype(np.float32), uv.astype(np.float32)


def _both_lk(img1, img2, uv, valid, **kw):
    ja = [jnp.asarray(x) for x in (img1, img2, uv, uv, valid)]
    uv_j, ok_j = JK.lk_level(*ja, **kw)
    uv_t, ok_t = TKer.lk_level_ref(_t(img1), _t(img2), _t(uv), _t(uv), _t(valid, torch.bool), **kw)
    return np.asarray(uv_j), np.asarray(ok_j), uv_t.numpy(), ok_t.numpy()


def test_lk_level_ref_matches():
    img1, img2, uv = _lk_scene()
    valid = np.ones(len(uv), bool)
    uv_j, ok_j, uv_t, ok_t = _both_lk(img1, img2, uv, valid)
    assert (ok_j == ok_t).all()
    assert ok_t.sum() >= 24
    # identical arithmetic up to the order of the 225-term sums
    assert np.abs(uv_j[ok_j] - uv_t[ok_t]).max() < 1e-3
    np.testing.assert_allclose(np.median(uv_t[ok_t] - uv[ok_t], axis=0), [2.0, -1.0], atol=0.05)
    # and against the Pallas kernel wherever both keep the track
    # (first 16 tracks: the interpreted Pallas kernel is slow)
    sub = [jnp.asarray(x[:16]) for x in (uv, uv, valid)]
    uv_p, ok_p = lk_level_pallas(jnp.asarray(img1), jnp.asarray(img2), *sub, interpret=True)
    both = np.asarray(ok_p) & ok_t[:16]
    assert both.sum() >= 12
    assert np.abs(np.asarray(uv_p)[both] - uv_t[:16][both]).max() < 1e-3


@pytest.mark.parametrize("H,W", [(30, 160), (34, 160), (370, 256)])
def test_lk_level_ref_short_and_unaligned_heights(H, W):
    img1, img2, _ = _lk_scene(seed=H, H=max(H, 48), W=W, N=4, shift=(1, 1))
    img1, img2 = np.ascontiguousarray(img1[:H]), np.ascontiguousarray(img2[:H])
    rng = np.random.default_rng(H)
    uv = np.stack([rng.uniform(20, W - 20, 16), np.linspace(H - 10.0, H - 9.0, 16)], 1).astype(np.float32)
    valid = np.ones(len(uv), bool)
    uv_j, ok_j, uv_t, ok_t = _both_lk(img1, img2, uv, valid)
    assert (ok_j == ok_t).all()
    if ok_t.any():
        assert np.abs(uv_j[ok_t] - uv_t[ok_t]).max() < 1e-3
    assert not np.isnan(uv_t).any()


def test_lk_level_ref_border_and_invalid():
    img1, img2, uv = _lk_scene()
    uv[0] = (2.0, 2.0)  # template window out of bounds
    uv[1] = (157.0, 117.0)  # bottom-right corner
    valid = np.ones(len(uv), bool)
    valid[2] = False
    uv_j, ok_j, uv_t, ok_t = _both_lk(img1, img2, uv, valid)
    assert not ok_t[0] and not ok_t[1] and not ok_t[2]
    assert (ok_j == ok_t).all()
    # the iterated positions of dropped tracks agree too (lk_track seeds
    # the next level with them)
    assert np.abs(uv_j - uv_t).max() < 1e-3


def test_lk_track_matches():
    img1, img2, uv = _lk_scene(seed=5, H=240, W=320, N=48, shift=(5, -3))
    valid = np.ones(len(uv), bool)
    valid[::7] = False
    # the defaults (4 levels, coarse_iters = 6), then a 3-level pyramid
    # with other iteration counts
    for levels, kw in ((4, {}), (3, dict(iters=8, coarse_iters=3))):
        pj = [JK.build_pyramid(jnp.asarray(im), levels) for im in (img1, img2)]
        pt = [TK.build_pyramid(_t(im), levels) for im in (img1, img2)]
        uv_j, ok_j = JK.lk_track(pj[0], pj[1], jnp.asarray(uv), jnp.asarray(valid), **kw)
        uv_t, ok_t = TK.lk_track(pt[0], pt[1], _t(uv), _t(valid, torch.bool), **kw)
        uv_j, ok_j = np.asarray(uv_j), np.asarray(ok_j)
        assert (ok_j == ok_t.numpy()).all()
        assert ok_j.sum() >= 30
        assert np.abs(uv_j[ok_j] - uv_t.numpy()[ok_j]).max() < 1e-3


def test_grid_detect_matches():
    img = _render_like(7, H=240, W=376)
    score = np.asarray(JK.fast_score(jnp.asarray(img), 20.0))
    rng = np.random.default_rng(7)
    # several features per cell, active and inactive mixed: duplicates
    # resolve to the last feature of the cell
    occ_uv = rng.uniform(0, [376, 240], (150, 2)).astype(np.float32)
    occ_mask = rng.uniform(size=150) < 0.3
    a_uv, a_ok = JK.grid_detect(jnp.asarray(score), 6, 8, jnp.asarray(occ_uv), jnp.asarray(occ_mask), per_cell=4)
    b_uv, b_ok = TK.grid_detect(_t(score), 6, 8, _t(occ_uv), _t(occ_mask, torch.bool), per_cell=4)
    np.testing.assert_array_equal(np.asarray(a_ok), b_ok.numpy())
    np.testing.assert_array_equal(np.asarray(a_uv), b_uv.numpy())
    assert b_ok.sum() > 10


def test_ransac_matches_with_jax_noise():
    rng = np.random.default_rng(11)
    N = 150
    # two views of a random 3D scene, 10% outliers
    X = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(4, 8, (N, 1))], axis=1)
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    X2 = X @ R.T + np.array([0.2, 0.01, 0.05])
    x1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    x2 = (X2[:, :2] / X2[:, 2:]).astype(np.float32)
    x2 = x2 + rng.normal(scale=5e-4, size=x2.shape).astype(np.float32)
    # outliers well off the threshold: a Sampson distance within float32
    # rounding of it can flip between two LAPACK builds' eigenvectors
    off = rng.uniform(0.02, 0.05, (15, 2)) * rng.choice([-1.0, 1.0], (15, 2))
    x2[:15] += off.astype(np.float32)
    valid = rng.uniform(size=N) < 0.9
    thresh = 2.0 / 450.0
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        a = np.asarray(JK.ransac_fundamental(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key, thresh))
        g = torch.as_tensor(np.array(jax.random.gumbel(key, (64, 8, N), jnp.float32)))
        b = TK.ransac_fundamental(_t(x1), _t(x2), _t(valid, torch.bool), thresh, gumbel=g).numpy()
        np.testing.assert_array_equal(a, b)
        assert 100 < b.sum() < valid.sum()

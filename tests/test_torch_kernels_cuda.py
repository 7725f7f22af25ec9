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


def test_fast9_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    for img in (torch.as_tensor(_blobs(0), device=dev),
                torch.rand((65, 257), generator=gen, device=dev) * 255.0):
        K.reset_launch_counts()
        a = K.fast_score(img, 20.0)
        assert K.launch_counts["fast9"] == 1
        b = K.fast_score_ref(img, 20.0)
        # same ring order, same float32 sums: bitwise in practice
        assert (a - b).abs().max().item() <= 1e-4
        assert (a > 0).any().item()


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

"""The frontend's two hand-written CUDA kernels and their plain versions.

Counterpart of `uvio_tpu/frontend/pallas_kernels.py`:

  * `fast_score`  — FAST-9 corner score map (`csrc/fast9.cu`, replaces
    `fast_score_pallas`), plain version `fast_score_ref`;
  * `lk_level`    — one pyramid level of Lucas-Kanade for a feature
    batch (`csrc/lk_level.cu`, replaces `lk_level_pallas` under both
    `batched` settings), plain version `lk_level_ref`.

A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises. Each kernel launch adds
one to `launch_counts[name]`, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3 (OpenCV FAST-16 layout): (dy, dx)
_CIRCLE = [
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
]

launch_counts = {"fast9": 0, "lk_level": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(s is not None and a != s for a, s in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(*tensors) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# FAST-9
# ---------------------------------------------------------------------------


def fast_score_ref(img: torch.Tensor, thresh: float = 20.0) -> torch.Tensor:
    """Plain FAST-9 score map (same contract as `klt.fast_score`): 16
    shifted copies, arc contiguity by rolled ANDs, score accumulated in
    ring order, 3-px borders zeroed."""
    diffs = [torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) - img for dy, dx in _CIRCLE]
    d = torch.stack(diffs)  # (16,H,W)
    brighter = d > thresh
    darker = d < -thresh

    def arc9(mask):
        acc = mask
        for r in range(1, 9):
            acc = acc & torch.roll(mask, -r, dims=0)
        return acc.any(0)

    mag = torch.zeros_like(img)
    for s in range(16):  # sequential, as the kernel accumulates
        mag = mag + torch.where(brighter[s] | darker[s], d[s].abs() - thresh, torch.zeros_like(img))
    score = torch.where(arc9(brighter) | arc9(darker), mag, torch.zeros_like(mag))
    score[:3, :] = 0.0
    score[-3:, :] = 0.0
    score[:, :3] = 0.0
    score[:, -3:] = 0.0
    return score


def fast_score(img: torch.Tensor, thresh: float = 20.0) -> torch.Tensor:
    """FAST-9 score map of a float32 (H,W) image in [0,255]."""
    if not _route(img):
        return fast_score_ref(img, thresh)
    from .. import _build

    _check("img", img, torch.float32, (None, None))
    H, W = img.shape
    out = torch.empty_like(img)
    rc = _build.load().uvio_fast9(img.data_ptr(), out.data_ptr(), H, W, float(thresh), _stream(img))
    if rc != 0:
        raise RuntimeError(f"uvio_fast9 launch failed: cudaError {rc}")
    launch_counts["fast9"] += 1
    return out


# ---------------------------------------------------------------------------
# Lucas-Kanade, one pyramid level
# ---------------------------------------------------------------------------


def _bilinear_patches(img, center, half):
    """(N,P,P) bilinear patches at subpixel centers (N,2), with the
    window start clipped into the image, and (N,) in-bounds flags
    (`klt._bilinear_patch`)."""
    H, W = img.shape
    size = 2 * half + 1
    fcx = torch.floor(center[:, 0])
    fcy = torch.floor(center[:, 1])
    x0 = fcx.long() - half
    y0 = fcy.long() - half
    fx = (center[:, 0] - fcx)[:, None, None]
    fy = (center[:, 1] - fcy)[:, None, None]
    ar = torch.arange(size + 1, device=img.device)
    rows = torch.clamp(y0, 0, H - size - 1)[:, None] + ar
    cols = torch.clamp(x0, 0, W - size - 1)[:, None] + ar
    block = img[rows[:, :, None], cols[:, None, :]]  # (N,P+1,P+1)
    top = block[:, :-1, :-1] * (1 - fx) + block[:, :-1, 1:] * fx
    bot = block[:, 1:, :-1] * (1 - fx) + block[:, 1:, 1:] * fx
    patch = top * (1 - fy) + bot * fy
    in_bounds = (x0 >= 0) & (y0 >= 0) & (x0 + size + 1 < W) & (y0 + size + 1 < H)
    return patch, in_bounds


def lk_level_ref(img_prev, img_next, uv_prev, uv_guess, valid, half=7, iters=10, min_eig=25.0):
    """Plain one-level LK for a feature batch (same contract as
    `klt.lk_level`). Returns (uv_new (N,2), ok (N,))."""
    tmpl, ok0 = _bilinear_patches(img_prev, uv_prev, half)
    zero = torch.zeros_like(tmpl[:, :, :1])
    gx = 0.5 * (tmpl[:, :, 2:] - tmpl[:, :, :-2])
    gx = torch.cat([zero, gx, zero], dim=2)
    zero = torch.zeros_like(tmpl[:, :1, :])
    gy = 0.5 * (tmpl[:, 2:, :] - tmpl[:, :-2, :])
    gy = torch.cat([zero, gy, zero], dim=1)
    Gxx = (gx * gx).sum((1, 2))
    Gxy = (gx * gy).sum((1, 2))
    Gyy = (gy * gy).sum((1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    eig = 0.5 * (Gxx + Gyy - torch.sqrt((Gxx - Gyy) ** 2 + 4 * Gxy**2))
    good = det > 1e-6
    safe_det = torch.where(good, det, torch.ones_like(det))

    p = uv_guess
    ok_iter = ok0
    for _ in range(iters):
        cur, okp = _bilinear_patches(img_next, p, half)
        err = cur - tmpl
        bx = (gx * err).sum((1, 2))
        by = (gy * err).sum((1, 2))
        dx = (Gyy * bx - Gxy * by) / safe_det
        dy = (Gxx * by - Gxy * bx) / safe_det
        p_new = p - torch.stack([dx, dy], dim=-1)
        p = torch.where((good & okp)[:, None], p_new, p)
        ok_iter = ok_iter & okp
    return p, valid & ok0 & ok_iter & good & (eig >= min_eig)


def lk_level(img_prev, img_next, uv_prev, uv_guess, valid, half=7, iters=10, min_eig=25.0):
    """One LK level: images (H,W) float32, uv_prev/uv_guess (N,2) float32,
    valid (N,) bool. Returns (uv_new (N,2), ok (N,))."""
    if not _route(img_prev, img_next, uv_prev, uv_guess, valid):
        return lk_level_ref(img_prev, img_next, uv_prev, uv_guess, valid, half, iters, min_eig)
    from .. import _build

    if not 0 <= half <= 7:
        raise ValueError(f"lk_level kernel supports half <= 7, got {half}")
    _check("img_prev", img_prev, torch.float32, (None, None))
    H, W = img_prev.shape
    _check("img_next", img_next, torch.float32, (H, W))
    _check("uv_prev", uv_prev, torch.float32, (None, 2))
    N = uv_prev.shape[0]
    _check("uv_guess", uv_guess, torch.float32, (N, 2))
    _check("valid", valid, torch.bool, (N,))
    uv_out = torch.empty_like(uv_prev)
    ok_out = torch.empty_like(valid)
    rc = _build.load().uvio_lk_level(
        img_prev.data_ptr(), img_next.data_ptr(), H, W,
        uv_prev.data_ptr(), uv_guess.data_ptr(), valid.data_ptr(),
        uv_out.data_ptr(), ok_out.data_ptr(), N, int(half), int(iters), float(min_eig),
        _stream(img_prev),
    )
    if rc != 0:
        raise RuntimeError(f"uvio_lk_level launch failed: cudaError {rc}")
    launch_counts["lk_level"] += 1
    return uv_out, ok_out

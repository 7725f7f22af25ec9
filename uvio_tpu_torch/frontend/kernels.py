"""The frontend's hand-written CUDA kernels and their plain versions.

Counterpart of `uvio_tpu/frontend/pallas_kernels.py`:

  * `fast_score`  — FAST-9 corner score map (`csrc/fast9.cu`, replaces
    `fast_score_pallas`), plain version `fast_score_ref`;
  * `lk_track`    — pyramidal Lucas-Kanade for a feature batch in one
    launch (`csrc/lk_level.cu`: `lk_level_pallas` under both `batched`
    settings together with the level loop of `klt.lk_track`), plain
    version `lk_track_ref`;
  * `lk_level`    — one pyramid level, the same kernel on a one-level
    pyramid with the caller's guess, plain version `lk_level_ref`.

A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises. Each kernel launch adds
one to `launch_counts[name]`, and each replayed one to `replay_counts`
too (`launches.py`, which the filter's kernel shares).
"""

from __future__ import annotations

import torch

from ..launches import launch_counts, replay_counts, reset_launch_counts  # noqa: F401
from ..launches import route as _route

# Bresenham circle of radius 3 (OpenCV FAST-16 layout): (dy, dx)
_CIRCLE = [
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
]


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(t.shape) != len(shape) or any(s is not None and a != s for a, s in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


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
    score[:3, :].zero_()
    score[-3:, :].zero_()
    score[:, :3].zero_()
    score[:, -3:].zero_()
    return score


def fast_pretest(img: torch.Tensor, thresh: float = 20.0) -> torch.Tensor:
    """The kernel's compass pretest as a plain function: (H,W) bool, True
    where at least 2 of the ring positions 0, 4, 8, 12 are brighter than
    centre + thresh or at least 2 are darker than centre - thresh. Any 9
    contiguous ring positions hold 2 of those four, so a corner always
    passes; the kernel sums the ring only where this is True. (Borders
    wrap here and are zeroed by the score.)"""
    d = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) - img
                     for dy, dx in _CIRCLE[::4]])
    return ((d > thresh).sum(0) >= 2) | ((d < -thresh).sum(0) >= 2)


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
# Lucas-Kanade
# ---------------------------------------------------------------------------

LK_MIN_EIG = 25.0  # level 0's eigenvalue gate in `lk_track`
LK_SLAB_MARGIN = 8  # pixels of img_next the kernel stages around a window
LK_MAX_LEVELS = 8
LK_MAX_HALF = 7


def _window(center, half, H, W):
    """Per feature: the clipped integer start (x, y) of the (P+1)^2 block
    around a subpixel centre, its fractional offsets and the in-bounds
    flag (`klt._bilinear_patch`)."""
    size = 2 * half + 1
    fcx = torch.floor(center[:, 0])
    fcy = torch.floor(center[:, 1])
    x0 = fcx.long() - half
    y0 = fcy.long() - half
    in_bounds = (x0 >= 0) & (y0 >= 0) & (x0 + size + 1 < W) & (y0 + size + 1 < H)
    x = torch.clamp(x0, 0, W - size - 1)
    y = torch.clamp(y0, 0, H - size - 1)
    return x, y, center[:, 0] - fcx, center[:, 1] - fcy, in_bounds


def _blend(block, fx, fy):
    """(N,P,P) bilinear blend of (N,P+1,P+1) blocks."""
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    top = block[:, :-1, :-1] * (1 - fx) + block[:, :-1, 1:] * fx
    bot = block[:, 1:, :-1] * (1 - fx) + block[:, 1:, 1:] * fx
    return top * (1 - fy) + bot * fy


def _gather(img, y, x, size):
    """(N,size,size) blocks of a 2-d `img`, or of per-feature (N,h,w)
    images, starting at rows y (N,) and columns x (N,)."""
    ar = torch.arange(size, device=img.device)
    rows = (y[:, None] + ar)[:, :, None]
    cols = (x[:, None] + ar)[:, None, :]
    if img.dim() == 2:
        return img[rows, cols]
    return img[torch.arange(img.shape[0], device=img.device)[:, None, None], rows, cols]


def _bilinear_patches(img, center, half):
    """(N,P,P) bilinear patches at subpixel centers (N,2), with the
    window start clipped into the image, and (N,) in-bounds flags."""
    H, W = img.shape
    x, y, fx, fy, in_bounds = _window(center, half, H, W)
    return _blend(_gather(img, y, x, 2 * half + 2), fx, fy), in_bounds


def _lk_solve(img_prev, sample_next, uv_prev, uv_guess, valid, half, iters, min_eig):
    """One LK level; `sample_next(p)` gives the (N,P,P) windows of
    img_next at the estimates p and their in-bounds flags."""
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
        cur, okp = sample_next(p)
        err = cur - tmpl
        bx = (gx * err).sum((1, 2))
        by = (gy * err).sum((1, 2))
        dx = (Gyy * bx - Gxy * by) / safe_det
        dy = (Gxx * by - Gxy * bx) / safe_det
        p_new = p - torch.stack([dx, dy], dim=-1)
        p = torch.where((good & okp)[:, None], p_new, p)
        ok_iter = ok_iter & okp
    return p, valid & ok0 & ok_iter & good & (eig >= min_eig)


def lk_level_ref(img_prev, img_next, uv_prev, uv_guess, valid, half=7, iters=10, min_eig=25.0,
                 windows=None):
    """Plain one-level LK for a feature batch (same contract as
    `klt.lk_level`). Returns (uv_new (N,2), ok (N,)). A list given as
    `windows` receives every iteration's clipped window starts (x, y)."""
    H, W = img_next.shape

    def sample(p):
        x, y, fx, fy, in_bounds = _window(p, half, H, W)
        if windows is not None:
            windows.append((x, y))
        return _blend(_gather(img_next, y, x, 2 * half + 2), fx, fy), in_bounds

    return _lk_solve(img_prev, sample, uv_prev, uv_guess, valid, half, iters, min_eig)


def slab_extent(half: int, n: int) -> int:
    """Side of the kernel's search slab along an image axis of n pixels:
    the (P+1)-wide window block plus `LK_SLAB_MARGIN` on either side,
    or the whole axis when that is shorter."""
    return min(2 * half + 2 + 2 * LK_SLAB_MARGIN, n)


def slab_origin(w0, extent: int, n: int):
    """Slab start along one axis for a window starting at w0: the margin
    before it, kept inside the image. A window block always lies inside
    the slab staged around it."""
    return torch.clamp(w0 - LK_SLAB_MARGIN, 0, n - extent)


def slab_contains(w0, origin, extent: int, half: int):
    """Whether the window block starting at w0 lies inside the slab."""
    return (w0 >= origin) & (w0 + 2 * half + 2 <= origin + extent)


def lk_level_slab_ref(img_prev, img_next, uv_prev, uv_guess, valid, half=7, iters=10,
                      min_eig=25.0):
    """`lk_level_ref` reading img_next the way the kernel does: through a
    per-feature slab that is staged around the first window and staged
    again whenever a window leaves it. The samples are the same pixels,
    so the result is bitwise `lk_level_ref`'s. Returns (uv_new, ok,
    stagings (N,)), the last counting each feature's slab loads. (Inside
    one `lk_track` launch the kernel stages a lower level's first slab
    early, around zero flow, and so may stage once more than this.)"""
    H, W = img_next.shape
    N = uv_prev.shape[0]
    sh, sw = slab_extent(half, H), slab_extent(half, W)
    state = {
        "slab": torch.zeros((N, sh, sw), dtype=img_next.dtype, device=img_next.device),
        "x0": torch.zeros(N, dtype=torch.long, device=img_next.device),
        "y0": torch.zeros(N, dtype=torch.long, device=img_next.device),
        "staged": torch.zeros(N, dtype=torch.bool, device=img_next.device),
        "count": torch.zeros(N, dtype=torch.long, device=img_next.device),
    }

    def sample(p):
        x, y, fx, fy, in_bounds = _window(p, half, H, W)
        inside = (state["staged"] & slab_contains(x, state["x0"], sw, half)
                  & slab_contains(y, state["y0"], sh, half))
        x0 = torch.where(inside, state["x0"], slab_origin(x, sw, W))
        y0 = torch.where(inside, state["y0"], slab_origin(y, sh, H))
        fresh = img_next[(y0[:, None] + torch.arange(sh, device=p.device))[:, :, None],
                         (x0[:, None] + torch.arange(sw, device=p.device))[:, None, :]]
        state["slab"] = torch.where(inside[:, None, None], state["slab"], fresh)
        state["x0"], state["y0"] = x0, y0
        state["staged"] = torch.ones_like(inside)
        state["count"] = state["count"] + (~inside).long()
        return _blend(_gather(state["slab"], y - y0, x - x0, 2 * half + 2), fx, fy), in_bounds

    uv, ok = _lk_solve(img_prev, sample, uv_prev, uv_guess, valid, half, iters, min_eig)
    return uv, ok, state["count"]


def lk_track_ref(pyr_prev, pyr_next, uv_prev, valid, half=7, iters=10, coarse_iters=6,
                 level_fn=lk_level_ref):
    """Plain pyramidal LK (same contract as `klt.lk_track`), coarse to
    fine with scaled guesses: one `level_fn` call per level; coarse
    levels run min(iters, coarse_iters) iterations with min_eig = 0 (they
    only seed the guess); the ok mask is level 0's. With
    `level_fn=lk_level` on CUDA tensors it is the chain of one-level
    launches that one `lk_track` launch must equal bit for bit."""
    L = len(pyr_prev)
    guess = uv_prev / 2.0 ** (L - 1)
    ok = valid
    for lev in range(L - 1, -1, -1):
        uv_l = uv_prev / 2.0**lev
        guess, ok_l = level_fn(
            pyr_prev[lev], pyr_next[lev], uv_l, guess, valid, half,
            iters if lev == 0 else min(iters, coarse_iters),
            LK_MIN_EIG if lev == 0 else 0.0,
        )
        if lev == 0:
            ok = ok & ok_l
        else:
            guess = guess * 2.0
    return guess, ok


def _check_half(half):
    if not 0 <= half <= LK_MAX_HALF:
        raise ValueError(f"the LK kernel supports 0 <= half <= {LK_MAX_HALF}, got {half}")


def _check_level(name, img_prev, img_next, half):
    _check(f"{name}_prev", img_prev, torch.float32, (None, None))
    H, W = img_prev.shape
    _check(f"{name}_next", img_next, torch.float32, (H, W))
    if min(H, W) < 2 * half + 2:
        raise ValueError(f"{name}: {H}x{W} is smaller than the {2 * half + 2}-px window block")
    return H, W


def lk_level(img_prev, img_next, uv_prev, uv_guess, valid, half=7, iters=10, min_eig=25.0):
    """One LK level: images (H,W) float32, uv_prev/uv_guess (N,2) float32,
    valid (N,) bool. Returns (uv_new (N,2), ok (N,))."""
    if not _route(img_prev, img_next, uv_prev, uv_guess, valid):
        return lk_level_ref(img_prev, img_next, uv_prev, uv_guess, valid, half, iters, min_eig)
    from .. import _build

    _check_half(half)
    H, W = _check_level("img", img_prev, img_next, half)
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


def lk_track_args(pyr_prev, pyr_next):
    """The host arrays `uvio_lk_track` takes for two pyramids: (device
    pointers of pyr_prev, of pyr_next, heights, widths), `ctypes` arrays
    with one entry per level."""
    import ctypes

    L = len(pyr_prev)
    return (
        (ctypes.c_void_p * L)(*[im.data_ptr() for im in pyr_prev]),
        (ctypes.c_void_p * L)(*[im.data_ptr() for im in pyr_next]),
        (ctypes.c_int * L)(*[im.shape[0] for im in pyr_prev]),
        (ctypes.c_int * L)(*[im.shape[1] for im in pyr_prev]),
    )


def lk_track(pyr_prev, pyr_next, uv_prev, valid, half=7, iters=10, coarse_iters=6):
    """Pyramidal LK: pyr_prev/pyr_next lists of (H_l,W_l) float32 images,
    level 0 first; uv_prev (N,2) float32 level-0 pixels; valid (N,) bool.
    Returns (uv_new (N,2), ok (N,)). On CUDA tensors the whole pyramid is
    one kernel launch."""
    if not _route(*pyr_prev, *pyr_next, uv_prev, valid):
        return lk_track_ref(pyr_prev, pyr_next, uv_prev, valid, half, iters, coarse_iters)
    from .. import _build

    _check_half(half)
    L = len(pyr_prev)
    if not 1 <= L <= LK_MAX_LEVELS or len(pyr_next) != L:
        raise ValueError(f"the LK kernel takes 1..{LK_MAX_LEVELS} levels in both pyramids, "
                         f"got {L} and {len(pyr_next)}")
    for lev in range(L):
        _check_level(f"pyr[{lev}]", pyr_prev[lev], pyr_next[lev], half)
    _check("uv_prev", uv_prev, torch.float32, (None, 2))
    N = uv_prev.shape[0]
    _check("valid", valid, torch.bool, (N,))
    uv_out = torch.empty_like(uv_prev)
    ok_out = torch.empty_like(valid)
    rc = _build.load().uvio_lk_track(
        *lk_track_args(pyr_prev, pyr_next), L, uv_prev.data_ptr(), valid.data_ptr(),
        uv_out.data_ptr(), ok_out.data_ptr(), N, int(half), int(iters), int(coarse_iters),
        LK_MIN_EIG, _stream(uv_prev),
    )
    if rc != 0:
        raise RuntimeError(f"uvio_lk_track launch failed: cudaError {rc}")
    launch_counts["lk_track"] += 1
    return uv_out, ok_out

"""A plain KLT front end (OpenVINS's `TrackKLT` with `Grider_FAST`), in
PyTorch float32 on the CPU, written for the benchmark's check from the
published method. It imports nothing of the tracker it judges.

A frame's work, as `TrackKLT::feed_monocular` does it:

  * `equalize`: global histogram equalization (`cv::equalizeHist`);
  * `pyramid`: a 2x2-mean image pyramid, level 0 the full image;
  * `lk`: Bouguet's pyramidal Lucas-Kanade, coarse to fine, on bilinear
    15x15 windows with central-difference gradients of the template;
  * `ransac_distances`: RANSAC on the fundamental matrix from 8-point
    hypotheses in normalized (undistorted) coordinates, Sampson distance
    against 2 / max(fx, fy);
  * `fast_score` and `grid_detect`: FAST-9 corners and their best picks
    in each free cell of the grid.

Where the port makes its own documented choices, this follows them:

  * equalization's table is computed in float32 and rounded half to even;
  * LK runs a fixed count of iterations a level (6 on the coarse levels,
    10 on level 0) with no early stop, moves a track only while its
    window lies inside the image, and drops it at level 0 when its
    window ever left the image or the template's smaller eigenvalue of
    the gradient matrix is below 25;
  * the FAST score is the sum of |difference| - threshold over the ring
    pixels beyond the threshold, at pixels with 9 contiguous ones;
  * a grid cell takes up to min(4, ceil(N / cells)) picks by score (ties
    by the first in the cell's row-major order), each at least 3 px
    (Chebyshev) from a pick ranked above it, and is occupied when the
    last track (in slot order) whose pixel falls in it is alive;
  * RANSAC takes 64 hypotheses whose 8 samples are drawn with replacement
    as argmax(log(w) + G) over the valid tracks (w = 1, else 1e-9) with
    given Gumbel noise G, keeps the one with most inliers (the first of
    equals), and keeps every valid track when fewer than 12 are valid;
  * a hypothesis's F is the 8-point system's null vector by 4 steps of
    inverse iteration (`null_vector`);
  * undistortion is 20 fixed-point steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
LK_HALF = 7
LK_ITERS, LK_COARSE_ITERS = 10, 6
LK_MIN_EIG = 25.0
RANSAC_MIN_VALID = 12
UNDISTORT_ITERS = 20
# the Bresenham circle of radius 3, in order around it: (dy, dx)
CIRCLE = sorted({(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4) if round(math.hypot(dy, dx)) == 3
                 and abs(dy) + abs(dx) in (3, 4)}, key=lambda o: math.atan2(o[0], o[1]))


def equalize(img: torch.Tensor) -> torch.Tensor:
    """Histogram equalization of a float32 image of values in [0, 255]."""
    u8 = img.clamp(0.0, 255.0).long()
    hist = torch.bincount(u8.reshape(-1), minlength=256)
    cdf = torch.cumsum(hist, 0)
    cdf_min = cdf[torch.nonzero(hist)[0, 0]]
    denom = max(int(u8.numel() - cdf_min), 1)
    lut = torch.round((cdf - cdf_min).to(F32) / torch.tensor(float(denom), dtype=F32) * 255.0).clamp(0.0, 255.0)
    return lut[u8]


def pyramid(img: torch.Tensor, levels: int) -> list:
    """The pyramid of images (..., H, W), level 0 first."""
    out = [img]
    for _ in range(levels - 1):
        im = out[-1]
        H, W = (im.shape[-2] // 2) * 2, (im.shape[-1] // 2) * 2
        out.append(0.25 * (im[..., 0:H:2, 0:W:2] + im[..., 0:H:2, 1:W:2] + im[..., 1:H:2, 0:W:2]
                           + im[..., 1:H:2, 1:W:2]))
    return out


# --- FAST-9 and the grid ---------------------------------------------------------

def fast_score(img: torch.Tensor, thresh: float) -> torch.Tensor:
    """FAST-9 scores of images (B, H, W) of whole values in [0, 255]: 0
    where no corner, and within 3 px of the border. The sums are of whole
    numbers, so they are made in int16 and are exact. Any 9 contiguous
    ring pixels hold one of each two opposite ones, so the ring is read
    only where one of pixels 0 and 8, one of 4 and 12, one of 2 and 10 and
    one of 6 and 14 pass on the same side."""
    B, H, W = img.shape
    t = int(thresh)
    if t != thresh:
        raise ValueError("the threshold must be a whole number")
    im = img.to(torch.int16)
    c = im[:, 3:H - 3, 3:W - 3]

    def ring(o):
        dy, dx = CIRCLE[o]
        return im[:, 3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] - c

    pairs = [(ring(o), ring(o + 8)) for o in (0, 4, 2, 6)]
    cand = torch.zeros_like(c, dtype=torch.bool)
    for sign in (1, -1):
        side = None
        for a, b in pairs:
            ok = (sign * a > t) | (sign * b > t)
            side = ok if side is None else side & ok
        cand |= side
    b, y, x = torch.nonzero(cand, as_tuple=True)
    flat = im.reshape(-1)
    at = b * (H * W) + (y + 3) * W + (x + 3)
    d = torch.stack([flat[at + dy * W + dx] for dy, dx in CIRCLE]) - flat[at]  # (16, M)
    # the ring as a 16-bit mask a side, doubled so that a 9-long arc may wrap
    bit = (1 << torch.arange(16, dtype=torch.int32))[:, None]
    corner = torch.zeros(len(at), dtype=torch.bool)
    for side in (d > t, d < -t):
        m = (side.to(torch.int32) * bit).sum(0, dtype=torch.int32)
        m = m | (m << 16)
        run = m
        for i in range(1, 9):
            run = run & (m >> i)
        corner |= (run & 0xFFFF) != 0
    # |d| - thresh summed over the ring pixels beyond the threshold
    at, d = at[corner], d[:, corner]
    score = torch.zeros_like(img)
    score.view(-1)[at] = (d.abs() - t).clamp(min=0).sum(0, dtype=torch.int32).to(img.dtype)
    return score


def grid_detect(score: torch.Tensor, grid_y: int, grid_x: int, per_cell: int, occ_uv: np.ndarray,
                occ_alive: np.ndarray):
    """(uv (B, G * per_cell, 2), ok (B, G * per_cell)): the best picks of
    each cell of each score map (B, H, W), cell by cell in row-major
    order; `occ_uv` (B, N, 2) and `occ_alive` (B, N) the tracks."""
    B, H, W = score.shape
    ch, cw = H // grid_y, W // grid_x
    G = grid_y * grid_x
    s = score[:, :ch * grid_y, :cw * grid_x].reshape(B, grid_y, ch, grid_x, cw).permute(0, 1, 3, 2, 4)
    # the best by score, the first in the cell among equals: scores are
    # whole numbers, so one int64 key orders both
    flat = s.reshape(B, G, ch * cw)
    n = ch * cw
    key = flat.to(torch.int64) * n + (n - 1 - torch.arange(n))
    idx = torch.topk(key, per_cell, dim=2).indices
    best = torch.gather(flat, 2, idx)
    g = torch.arange(G)[None, :, None]
    cy, cx = idx // cw, idx % cw
    uv = torch.stack([(g % grid_x) * cw + cx, (g // grid_x) * ch + cy], -1).to(F32)
    u = np.trunc(occ_uv).astype(np.int64)
    cell = np.clip(u[..., 1] // ch, 0, grid_y - 1) * grid_x + np.clip(u[..., 0] // cw, 0, grid_x - 1)
    occupied = np.zeros((B, G), bool)
    for bi in range(B):
        last = np.full(G, -1)
        last[cell[bi]] = np.arange(cell.shape[1])  # the last track of each cell wins
        occupied[bi] = (last >= 0) & occ_alive[bi][np.maximum(last, 0)]
    ok = (best > 1e-3) & ~torch.as_tensor(occupied)[..., None]
    for j in range(1, per_cell):
        near = ((cy[..., :j] - cy[..., j:j + 1]).abs() <= 2) & ((cx[..., :j] - cx[..., j:j + 1]).abs() <= 2)
        ok[..., j] &= ~near.any(-1)
    return uv.reshape(B, -1, 2), ok.reshape(B, -1)


# --- Lucas-Kanade ------------------------------------------------------------------

def _patches(img, f, p, half):
    """Bilinear (2h+1)^2 windows of images img (B, H, W), image f (M,) of
    each, around subpixel points p (M, 2), their integer block clamped
    into the image, and whether it lay inside."""
    _, H, W = img.shape
    size = 2 * half + 1
    fl = torch.floor(p)
    x0 = fl[:, 0].long() - half
    y0 = fl[:, 1].long() - half
    inside = (x0 >= 0) & (y0 >= 0) & (x0 + size + 1 < W) & (y0 + size + 1 < H)
    x0, y0 = x0.clamp(0, W - size - 1), y0.clamp(0, H - size - 1)
    ar = torch.arange(size + 1)
    at = (f * (H * W) + y0 * W + x0)[:, None, None] + (ar * W)[:, None] + ar
    blk = img.reshape(-1)[at]
    fx = (p[:, 0] - fl[:, 0])[:, None, None]
    fy = (p[:, 1] - fl[:, 1])[:, None, None]
    top = blk[:, :-1, :-1] * (1 - fx) + blk[:, :-1, 1:] * fx
    bot = blk[:, 1:, :-1] * (1 - fx) + blk[:, 1:, 1:] * fx
    return top * (1 - fy) + bot * fy, inside


def _edge_margin(p, half, H, W):
    """Distance of each point to where its window's inside test flips."""
    lo = float(half)
    hx, hy = float(W - half - 2), float(H - half - 2)
    return torch.stack([(p[:, 0] - lo).abs(), (p[:, 0] - hx).abs(), (p[:, 1] - lo).abs(), (p[:, 1] - hy).abs()],
                       1).min(1).values


def lk(pyr_prev, pyr_next, f, uv, valid, half=LK_HALF):
    """Pyramidal LK of the points uv (M, 2) (level-0 pixels) from image f
    (M,) of the pyramids `pyr_prev` to the same image of `pyr_next` (lists
    of (B, H_l, W_l), level 0 first): (uv_new, ok, eig at level 0, the
    smallest margin any iterate kept to a window edge, in level-0
    pixels, and the length of the last step at level 0)."""
    L = len(pyr_prev)
    guess = uv / 2.0 ** (L - 1)
    margin = torch.full((len(uv),), float("inf"))
    for lev in range(L - 1, -1, -1):
        iters = LK_ITERS if lev == 0 else min(LK_ITERS, LK_COARSE_ITERS)
        _, H, W = pyr_next[lev].shape
        u = uv / 2.0 ** lev
        tmpl, ok0 = _patches(pyr_prev[lev], f, u, half)
        gx = torch.zeros_like(tmpl)
        gy = torch.zeros_like(tmpl)
        gx[:, :, 1:-1] = 0.5 * (tmpl[:, :, 2:] - tmpl[:, :, :-2])
        gy[:, 1:-1, :] = 0.5 * (tmpl[:, 2:, :] - tmpl[:, :-2, :])
        Gxx, Gxy, Gyy = (gx * gx).sum((1, 2)), (gx * gy).sum((1, 2)), (gy * gy).sum((1, 2))
        det = Gxx * Gyy - Gxy * Gxy
        eig = 0.5 * (Gxx + Gyy - torch.sqrt((Gxx - Gyy) ** 2 + 4 * Gxy ** 2))
        good = det > 1e-6
        sdet = torch.where(good, det, torch.ones_like(det))
        margin = torch.minimum(margin, _edge_margin(u, half, H, W) * 2.0 ** lev)
        p, inside_all = guess, ok0
        for _ in range(iters):
            margin = torch.minimum(margin, _edge_margin(p, half, H, W) * 2.0 ** lev)
            cur, inside = _patches(pyr_next[lev], f, p, half)
            e = cur - tmpl
            bx, by = (gx * e).sum((1, 2)), (gy * e).sum((1, 2))
            step = torch.stack([(Gyy * bx - Gxy * by) / sdet, (Gxx * by - Gxy * bx) / sdet], -1)
            moved = (good & inside)[:, None]
            p = torch.where(moved, p - step, p)
            inside_all = inside_all & inside
        if lev == 0:
            ok = valid & inside_all & good & (eig >= LK_MIN_EIG)
            return p, ok, eig, margin, torch.where(moved[:, 0], step.norm(dim=1), torch.zeros_like(eig))
        guess = p * 2.0


# --- RANSAC --------------------------------------------------------------------------

def undistort(intr: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalized points of the radtan camera, float32."""
    fx, fy, cx, cy, k1, k2, p1, p2 = intr
    pt = (uv - torch.stack([cx, cy])) / torch.stack([fx, fy])
    xy = pt
    for _ in range(UNDISTORT_ITERS):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        t = torch.stack([2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x), p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y], -1)
        xy = (pt - t) / radial[..., None]
    return xy


def sampson(F, x1, x2):
    """Sampson distances (B, K, N) of float64 correspondences x (B, N, 2)
    under hypotheses F (B, K, 3, 3), with what decides how far rounding
    can move one: the epipolar residual x2^T F x1's magnitude, the
    distance's denominator, and the sum of the residual's nine terms'
    magnitudes (rounding each term's factors moves the residual by that
    sum times their relative error)."""
    X1 = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    X2 = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    Fx1 = torch.einsum("bkij,bnj->bkni", F, X1)
    Ftx2 = torch.einsum("bkji,bnj->bkni", F, X2)
    r = (X2[:, None] * Fx1).sum(-1)
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2).clamp(min=1e-12)
    terms = torch.einsum("bkij,bni,bnj->bkn", F.abs(), X2.abs(), X1.abs())
    return r * r / den, r.abs(), den, terms


NULL_ITERS = 4


def null_vector(M):
    """Unit vectors v with M v ~ 0 for symmetric PSD M (..., 9, 9) in
    float64: `NULL_ITERS` steps of inverse iteration on M + eps I, eps =
    1e-13 trace(M), from the start (1, ..., 2) spaced evenly (the port's
    documented null vector; an 8-point system whose samples repeat has a
    null space of two or more dimensions, in which this start picks the
    answer)."""
    n = M.shape[-1]
    eps = 1e-13 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) + 1e-300
    L, info = torch.linalg.cholesky_ex(M + eps[..., None, None] * torch.eye(n, dtype=M.dtype))
    # a factor that fails anyway gives NaN, which no Sampson test accepts
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    v = torch.linspace(1.0, 2.0, n, dtype=M.dtype).expand(*M.shape[:-1])[..., None]
    for _ in range(NULL_ITERS):
        v = torch.cholesky_solve(v, L)
        v = v / torch.linalg.vector_norm(v, dim=-2, keepdim=True)
    return v[..., 0]


def ransac_distances(xn1, xn2, valid, gumbel):
    """The Sampson distances (B, K, N), in float64, of every track under
    each of the K hypotheses of each frame, with `sampson`'s residual,
    denominator and terms: xn (B, N, 2) normalized points before and after,
    valid (B, N), gumbel (B, K, 8, N). A hypothesis's F is the null vector
    of its 8-point system in float64 (`null_vector`), rounded to float32 as
    the estimator keeps it."""
    w = valid.to(F32) + 1e-9
    idx = torch.argmax(torch.log(w)[:, None, None, :] + gumbel, dim=-1)  # (B, K, 8)
    bi = torch.arange(len(idx))[:, None, None]
    a, b = xn1[bi, idx].double(), xn2[bi, idx].double()
    u1, v1, u2, v2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], -1)
    F = null_vector(A.transpose(-1, -2) @ A).reshape(*idx.shape[:2], 3, 3).to(F32).double()
    return sampson(F, xn1.double(), xn2.double())

"""Vision frontend: histogram equalization, image pyramid, grid corner
detection, pyramidal Lucas–Kanade, fundamental-matrix RANSAC.

Port of `uvio_tpu/frontend/klt.py` (the reference's
`ov_core/src/track/TrackKLT.{h,cpp}` + `Grider_GRID`). The FAST-9 score
map and pyramidal LK (`lk_track`, one launch for all levels) are the
CUDA kernels of `kernels.py`; everything else is plain PyTorch. Images
are float32 (H,W) in [0,255]; all shapes are static and nothing here
waits for the host.
"""

from __future__ import annotations

import torch

from .kernels import fast_score, lk_level, lk_track

__all__ = [
    "RANSAC_HYPOTHESES", "build_pyramid", "fast_score", "grid_detect", "gumbel_noise",
    "hist_equalize", "lk_level", "lk_track", "ransac_fundamental",
]


def hist_equalize(img: torch.Tensor) -> torch.Tensor:
    """Global histogram equalization with `cv2::equalizeHist` semantics:
    lut(v) = round((cdf(v) - cdf_min) / (N - cdf_min) * 255), cdf_min the
    first nonzero bin's cdf, values truncated to int and the LUT rounded
    half-to-even in float32, as in `uvio_tpu`.

    The histogram is a `scatter_add_`: `torch.bincount` on CUDA reads
    the input's maximum back to the host to size its output."""
    u8 = torch.clamp(img, 0.0, 255.0).to(torch.int64)
    flat = u8.reshape(-1)
    hist = torch.zeros(256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(0, flat, torch.ones_like(flat))
    cdf = torch.cumsum(hist, 0)
    big = torch.full_like(cdf, torch.iinfo(torch.int64).max)
    cdf_min = torch.where(hist > 0, cdf, big).min()
    denom = torch.clamp(flat.numel() - cdf_min, min=1)
    lut = torch.round((cdf - cdf_min).to(torch.float32) / denom.to(torch.float32) * 255.0)
    lut = torch.clamp(lut, 0.0, 255.0)
    return lut[u8]


def build_pyramid(img: torch.Tensor, levels: int):
    """2x average-pool pyramid (a 2x2 sum times 0.25), level 0 = full
    resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        im = pyr[-1]
        H, W = im.shape
        im = im[: H - H % 2, : W - W % 2]
        s = im.reshape(H // 2, 2, W // 2, 2).sum((1, 3))
        pyr.append(0.25 * s)
    return pyr


def _stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties in
    ascending index order like `lax.top_k`."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_detect(
    score: torch.Tensor,
    grid_y: int,
    grid_x: int,
    occupied_uv: torch.Tensor,
    occupied_mask: torch.Tensor,
    min_score: float = 1e-3,
    per_cell: int = 1,
):
    """Top-N corners per free grid cell (Grider_GRID semantics).

    occupied_uv (N,2) current feature pixels; a cell is occupied when
    the LAST feature mapped to it (in index order) is active — the
    order in which `uvio_tpu`'s scatter resolves duplicate cells.
    Returns (uv (G*per_cell, 2), valid (G*per_cell,)).
    """
    H, W = score.shape
    ch, cw = H // grid_y, W // grid_x
    G = grid_y * grid_x
    dev = score.device
    cells = score[: ch * grid_y, : cw * grid_x].reshape(grid_y, ch, grid_x, cw)
    cells = cells.permute(0, 2, 1, 3).reshape(G, ch * cw)
    best_score, best = _stable_topk(cells, per_cell)  # (G, per_cell)
    cy = best // cw
    cx = best % cw
    g = torch.arange(G, device=dev)[:, None]
    uv = torch.stack([(g % grid_x) * cw + cx, (g // grid_x) * ch + cy], dim=-1).to(score.dtype)

    occ_cell = (
        torch.clamp(occupied_uv[:, 1].to(torch.int64) // ch, 0, grid_y - 1) * grid_x
        + torch.clamp(occupied_uv[:, 0].to(torch.int64) // cw, 0, grid_x - 1)
    )
    n_occ = occupied_uv.shape[0]
    last = torch.full((G,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, occ_cell, torch.arange(n_occ, device=dev), reduce="amax")
    occ = (last >= 0) & occupied_mask[torch.clamp(last, min=0)]
    valid = (best_score > min_score) & ~occ[:, None]
    if per_cell > 1:
        # drop a pick within 2 px Chebyshev of a higher-ranked one
        close = ((cy[:, :, None] - cy[:, None, :]).abs() <= 2) & (
            (cx[:, :, None] - cx[:, None, :]).abs() <= 2
        )
        higher = torch.tril(torch.ones((per_cell, per_cell), dtype=torch.bool, device=dev), -1)
        valid = valid & ~(close & higher).any(-1)
    return uv.reshape(G * per_cell, 2), valid.reshape(G * per_cell)


# inverse iterations of the 8-point null vector: each shrinks the error
# by (lambda_1 + eps) / (lambda_2 + eps), where lambda_1 is 0 up to
# rounding (8 rows, 9 unknowns) and eps is 1e-13 trace(M)
_NULL_ITERS = 4


def smallest_eigvec(M: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    matrices M (B,n,n), up to sign, by inverse iteration on
    M + eps I in float64 with a fixed iteration count.

    `torch.linalg.eigh` waits for the host to check its error code; this
    factors with `cholesky_ex(check_errors=False)` and two triangular
    solves per iteration, so it never does. eps = 1e-13 trace(M) keeps
    the factor positive definite against float64 rounding of M (~1e-15
    trace(M)); a factor that fails anyway gives NaN, which no Sampson
    test accepts, so that hypothesis counts no inliers."""
    M = M.to(torch.float64)
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    eps = 1e-13 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) + 1e-300
    L, _ = torch.linalg.cholesky_ex(M + eps[..., None, None] * eye, check_errors=False)
    # a start with no symmetry that would keep it orthogonal to the answer
    v = torch.linspace(1.0, 2.0, n, dtype=M.dtype, device=M.device).expand(*M.shape[:-1])
    v = v[..., None]
    for _ in range(_NULL_ITERS):
        y = torch.linalg.solve_triangular(L, v, upper=False)
        v = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
        v = v / torch.linalg.vector_norm(v, dim=-2, keepdim=True)
    return v[..., 0]


def _fundamental_8pt(x1, x2):
    """F from 8 normalized correspondences, batched: x (B,8,2) -> (B,3,3)
    as the smallest eigenvector of A^T A (`uvio_tpu` takes it from
    `eigh`; the sign, which `eigh` leaves free too, does not change a
    Sampson distance)."""
    dtype = x1.dtype
    x1, x2 = x1.to(torch.float64), x2.to(torch.float64)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1
    )
    f = smallest_eigvec(A.transpose(-1, -2) @ A)
    return f.to(dtype).reshape(-1, 3, 3)


def _sampson(F, x1, x2):
    """Sampson distances of all N correspondences under B hypotheses."""
    ones = torch.ones_like(x1[:, :1])
    X1 = torch.cat([x1, ones], dim=1)  # (N,3)
    X2 = torch.cat([x2, ones], dim=1)
    Fx1 = X1 @ F.transpose(-1, -2)  # (B,N,3)
    Ftx2 = X2 @ F
    num = (X2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise drawn on `device` from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


RANSAC_HYPOTHESES = 64  # `ransac_fundamental`'s default hypothesis count


def ransac_fundamental(uvn1, uvn2, valid, thresh, n_hyp=RANSAC_HYPOTHESES, gumbel=None, generator=None):
    """Masked batched RANSAC in normalized coordinates; returns the
    inlier mask (N,) of the best of `n_hyp` 8-point hypotheses.

    Samples are drawn with replacement among valid indices as
    `argmax(log(w) + G)` with Gumbel noise G (n_hyp, 8, N) — exactly how
    `jax.random.categorical` samples, so passing JAX's noise reproduces
    `uvio_tpu`'s samples. Without `gumbel`, G is drawn from `generator`
    on the inputs' device.
    """
    N = uvn1.shape[0]
    if gumbel is None:
        gumbel = gumbel_noise((n_hyp, 8, N), generator, uvn1.device)
    w = valid.to(torch.float32) + 1e-9
    idx = torch.argmax(torch.log(w) + gumbel, dim=-1)  # (n_hyp, 8)
    F = _fundamental_8pt(uvn1[idx], uvn2[idx])
    inl = (_sampson(F, uvn1, uvn2) < thresh**2) & valid  # (n_hyp, N)
    best = torch.argmax(inl.sum(-1), dim=0, keepdim=True)
    # degenerate protection: too few valid points keeps all valid
    return torch.where(valid.sum() >= 12, inl.index_select(0, best)[0], valid)

"""Descriptor-based tracker.

Port of `uvio_tpu/frontend/descriptor.py`, the equivalent of
`ov_core/src/track/TrackDescriptor.{h,cpp}` (ORB grid extraction +
Hamming knn matching with ratio test + symmetry check + RANSAC),
batched:

  * detection reuses the FAST grid detector;
  * descriptors are 256-bit BRIEF (seeded fixed point-pair pattern over
    a smoothed patch, packed into 8 words of 32 bits);
  * matching is one XOR + bit-count Hamming matrix with ratio and
    mutual-best (symmetry) tests, then fundamental RANSAC;
  * ORB rotation invariance (`TrackDescriptor.cpp:355-478` extracts
    oriented ORB): intensity-centroid orientation over a circular patch
    (the ORB moment method) steers the BRIEF sampling pattern, so
    matching survives in-plane rotation (aggressive UAV flight).

PyTorch has no population count and few operations on `uint32`, so a
descriptor's 8 words are int64 tensors holding the uint32 values
(`desc.cpu().numpy().astype(np.uint32)` is `uvio_tpu`'s array) and the
Hamming distance is taken on the 256 unpacked bits: exact integers
either way. Distances tie often; a tie goes to the lowest index, as
`jnp.argmin` resolves it and as `torch.argmin` on CUDA does not promise:
the minimum is taken over `distance * N + index`.

The device part of a `feed` (FAST-9, the grid, the descriptors and, after
the first frame, the Hamming match, with the packing for the one
read-back) is `step_first` and `step_match`, `uvio_tpu`'s `_jit_detect`
and `_jit_match`: on the card each is captured once as a CUDA graph and
replayed (`graphs.graphed`). RANSAC over the matched pairs, whose count
only the host knows, runs eagerly, as it runs outside the jits in
`uvio_tpu`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..cam import models as cam_models
from ..device import resolve_device
from ..graphs import graphed
from .klt import fast_score, grid_detect, ransac_fundamental
from .tracker import fetch, to_device

_N_BITS = 256
_PATCH_HALF = 15
_BIG = 10_000  # distance of a pair with an invalid side


def _brief_pattern(seed=7):
    rng = np.random.default_rng(seed)
    # Gaussian sampling like BRIEF; clamp inside the patch
    pts = np.clip(
        rng.normal(scale=_PATCH_HALF / 2.5, size=(_N_BITS, 2, 2)),
        -_PATCH_HALF + 1,
        _PATCH_HALF - 1,
    )
    return pts.astype(np.float32)


_PATTERN = _brief_pattern()


def _disk_offsets(radius=_PATCH_HALF):
    """Integer offsets of a filled disk (static, for the ORB moments)."""
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    m = ys**2 + xs**2 <= radius**2
    return np.stack([xs[m], ys[m]], axis=1).astype(np.float32)  # (K,2)


_DISK = _disk_offsets()


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(pattern (256,2,2), disk (K,2)) as float32 tensors on `device`."""
    return torch.as_tensor(_PATTERN, device=device), torch.as_tensor(_DISK, device=device)


def _smooth(img):
    """5x5 box blur with zero padding (the BRIEF pre-smoothing)."""
    k = torch.ones((1, 1, 5, 5), dtype=img.dtype, device=img.device) / 25.0
    return F.conv2d(img[None, None], k, padding=2)[0, 0]


def _bits(img, uv, valid, oriented=True):
    """The 256 comparison bits per point, (N,256) bool, and ok (N,)."""
    H, W = img.shape
    sm = _smooth(img)
    pattern, disk = _constants(img.device)
    cx, cy = uv[:, 0], uv[:, 1]
    if oriented:
        # ORB moments on integer pixels of the disk around each point
        px = torch.clamp(torch.round(cx[:, None] + disk[None, :, 0]).to(torch.int64), 0, W - 1)
        py = torch.clamp(torch.round(cy[:, None] + disk[None, :, 1]).to(torch.int64), 0, H - 1)
        inten = img[py, px]  # (N,K)
        m10 = (disk[None, :, 0] * inten).sum(1)
        m01 = (disk[None, :, 1] * inten).sum(1)
        theta = torch.atan2(m01, m10)
        ct = torch.cos(theta).to(torch.float32)[:, None, None]
        st = torch.sin(theta).to(torch.float32)[:, None, None]
        # the pattern rotated by theta, written out (a 2x2 product)
        pat = torch.stack(
            [ct * pattern[None, ..., 0] - st * pattern[None, ..., 1],
             st * pattern[None, ..., 0] + ct * pattern[None, ..., 1]], dim=-1
        )  # (N,256,2,2)
    else:
        pat = pattern[None]
    # sample both endpoints of each pair (bilinear)
    pts = pat + uv[:, None, None, :]  # (N,256,2,2) absolute xy
    x = torch.clamp(pts[..., 0], 0, W - 2)
    y = torch.clamp(pts[..., 1], 0, H - 2)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    val = (
        sm[y0, x0] * (1 - fx) * (1 - fy)
        + sm[y0, x0 + 1] * fx * (1 - fy)
        + sm[y0 + 1, x0] * (1 - fx) * fy
        + sm[y0 + 1, x0 + 1] * fx * fy
    )  # (N,256,2)
    bits = val[..., 0] < val[..., 1]
    # steered pattern can reach sqrt(2) * patch half
    margin = int(np.ceil(_PATCH_HALF * np.sqrt(2.0))) if oriented else _PATCH_HALF
    inb = (cx > margin) & (cx < W - margin - 1) & (cy > margin) & (cy < H - margin - 1)
    return bits, valid & inb


def _pack(bits):
    """(N,256) bool -> (N,8) int64 words, bit k of word w = bit 32 w + k."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(-1)


def _unpack(desc):
    """(N,8) words -> (N,256) uint8 bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    return ((desc.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(-1, _N_BITS).to(torch.uint8)


def describe(img, uv, valid, oriented=True):
    """256-bit (optionally steered) BRIEF descriptors at uv (N,2).

    `oriented=True` computes the ORB intensity-centroid angle
    theta = atan2(m01, m10) over a radius-15 disk and rotates the
    sampling pattern by it (rotation-invariant matching).
    Returns (desc (N,8) int64 holding uint32 values, ok (N,))."""
    bits, ok = _bits(img, uv, valid, oriented)
    return _pack(bits), ok


def _first_argmin(dist, dim):
    """(min, argmin) of an integer matrix along `dim`, ties to the
    lowest index."""
    n = dist.shape[dim]
    shape = [1, 1]
    shape[dim] = n
    keyed = dist * n + torch.arange(n, device=dist.device).reshape(shape)
    best = keyed.min(dim).values
    return best // n, best % n


def hamming_match(d1, v1, d2, v2, ratio=0.75):
    """Mutual-best Hamming matching with ratio test.

    d1 (N1,8), d2 (N2,8) words. Returns idx2_for_1 (N1,) int64 (-1 = no
    match): `robust_match`'s knn+ratio+symmetry, batched."""
    b1, b2 = _unpack(d1), _unpack(d2)
    dist = (b1[:, None, :] ^ b2[None, :, :]).sum(-1, dtype=torch.int64)  # (N1,N2)
    dist = torch.where(v1[:, None] & v2[None, :], dist, torch.full_like(dist, _BIG))
    n1 = dist.shape[0]
    ar1 = torch.arange(n1, device=dist.device)

    bestd, best2 = _first_argmin(dist, 1)
    # second best for ratio test (a scatter of the Python value: an index
    # assignment would lift it into a host tensor first)
    second = dist.scatter(1, best2[:, None], _BIG).min(1).values
    ratio_ok = bestd < ratio * second
    # symmetry: 1's best in 2 must map back to 1
    _, best1_of_2 = _first_argmin(dist, 0)  # (N2,)
    mutual = best1_of_2[best2] == ar1
    ok = ratio_ok & mutual & (bestd < _BIG)
    return torch.where(ok, best2, torch.full_like(best2, -1))


class DescriptorTracker:
    """TrackDescriptor-equivalent with the KLTTracker interface. On CUDA
    tensors a `feed` launches the `fast9` kernel once."""

    def __init__(
        self,
        intrinsics: np.ndarray,
        cam_model: int = 0,
        num_features: int = 150,
        grid: tuple = (8, 10),
        fast_thresh: float = 20.0,
        knn_ratio: float = 0.75,
        cam_id: int = 0,
        device=None,
        generator: torch.Generator = None,
    ):
        self.device = resolve_device(device)
        self.intrinsics = torch.as_tensor(
            np.asarray(intrinsics), dtype=torch.float32, device=self.device
        )
        self.cam_model = cam_model
        self.grid = grid
        self.fast_thresh = fast_thresh
        self.knn_ratio = knn_ratio
        self.cam_id = cam_id
        fx, fy = float(intrinsics[0]), float(intrinsics[1])
        self.ransac_thresh = 2.0 / max(fx, fy)
        self.prev = None  # (uv host, desc device, valid device, ids host)
        self.next_id = 0
        self.generator = generator
        if generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(1)
        # the device part of `feed`, graphed (`.eager` is the plain one)
        self.step_first = graphed(self._device_first, "DescriptorTracker first frame")
        self.step_match = graphed(self._device_match, "DescriptorTracker matching")

    def _detect(self, img):
        score = fast_score(img, self.fast_thresh)
        uv, ok = grid_detect(
            score, self.grid[0], self.grid[1],
            torch.zeros((1, 2), dtype=img.dtype, device=img.device),
            torch.zeros(1, dtype=torch.bool, device=img.device),
        )
        desc, ok2 = describe(img, uv, ok)
        return uv, desc, ok & ok2

    def _device_first(self, img_d):
        """A first frame's device part: (descriptors, valid, [uv | valid]
        packed (G,3))."""
        uv, desc, valid = self._detect(img_d)
        return desc, valid, torch.cat([uv, valid[:, None].to(uv.dtype)], dim=1).to(torch.float32)

    def _device_match(self, p_desc, p_valid, img_d):
        """A later frame's device part: detection, then the match of the
        previous frame's descriptors into this one's: (descriptors, valid,
        [uv | valid | match] packed (G,4))."""
        uv, desc, valid = self._detect(img_d)
        m = hamming_match(p_desc, p_valid, desc, valid, ratio=self.knn_ratio)
        cols = [uv, valid[:, None].to(uv.dtype), m[:, None].to(uv.dtype)]
        return desc, valid, torch.cat(cols, dim=1).to(torch.float32)

    def feed(self, t: float, img: np.ndarray, gumbel: torch.Tensor = None):
        """Returns (ids (N,), uvs (N,2)) of this frame's valid corners,
        matched ones under their previous ids. `gumbel`, (64, 8, number
        of matched pairs), replaces the generator's draw in RANSAC."""
        img_d = to_device(img, self.device)
        # one read-back: corners, their mask and (after the first frame)
        # the matches
        if self.prev is None:
            desc, valid_d, packed = self.step_first(img_d)
        else:
            p_uv, p_desc, p_valid, p_ids = self.prev
            desc, valid_d, packed = self.step_match(p_desc, p_valid, img_d)
        host = packed.cpu().numpy()
        ids = np.full(host.shape[0], -1, np.int64)
        uv, valid = host[:, :2].copy(), host[:, 2] != 0
        if self.prev is not None:
            m = host[:, 3].astype(np.int64)
            # RANSAC on the matched pairs
            src = np.nonzero(m >= 0)[0]
            dst = m[src]
            if len(src) >= 12:
                uvn = cam_models.undistort(
                    self.intrinsics, self.cam_model,
                    to_device(np.concatenate([p_uv[src], uv[dst]]), self.device),
                )
                inl = ransac_fundamental(
                    uvn[: len(src)], uvn[len(src) :], torch.ones(len(src), dtype=torch.bool, device=self.device),
                    self.ransac_thresh, gumbel=gumbel, generator=self.generator,
                )
                keep = fetch(inl[:, None])[:, 0] != 0
                ids[dst[keep]] = p_ids[src[keep]]
        new = (ids < 0) & valid
        n_new = int(new.sum())
        ids[new] = np.arange(self.next_id, self.next_id + n_new)
        self.next_id += n_new
        self.prev = (uv, desc, valid_d, ids)
        sel = valid & (ids >= 0)
        return ids[sel], uv[sel]

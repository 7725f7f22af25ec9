"""KLT tracker orchestration (TrackKLT equivalent).

Port of `uvio_tpu/frontend/tracker.py`: persistent feature slots with
host-side id management; per-frame device work (histogram equalization,
pyramid, pyramidal LK, fundamental RANSAC, FAST grid detection with
occupancy). Emits (ids, uvs) per frame in the shape the manager's
`feed_features` consumes: a drop-in replacement for the simulator's
tracker on real or rendered images.

Mirrors `TrackKLT::feed_monocular` (`ov_core/src/track/TrackKLT.cpp:
96-200`): track forward, reject with RANSAC, re-detect into free grid
cells, all with static shapes and masks.

What differs from `uvio_tpu`, with the same results:

  * `uvio_tpu` equalizes and re-pyramids the previous image on every
    frame (and the left image once more in `stereo_match`), the price of
    one jitted call. Here the tracker keeps the previous frame's
    equalized image and pyramid (`prev_img`, `prev_pyr`) and
    `stereo_match` takes the left pyramid it already has.
    `hist_equalize` and `build_pyramid` are deterministic, so the
    outputs are bit-equal.
  * One read-back per `feed`: `uv_new`, `tracked`, `det_uv`, `det_ok`
    come back as one packed tensor; the image and the track table go up
    as pinned non-blocking copies.
  * RANSAC draws from an explicit `torch.Generator` (seeded 0 in the
    constructor unless one is given), or takes the Gumbel noise itself
    (`feed(..., gumbel=)`).

On CUDA tensors one `feed` launches the `fast9` kernel once and the
`lk_track` kernel once (`kernels.launch_counts`); on the CPU the
wrappers take their plain versions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cam import models as cam_models
from ..device import resolve_device
from .klt import (
    build_pyramid,
    fast_score,
    grid_detect,
    hist_equalize,
    lk_track,
    ransac_fundamental,
)


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A float32 copy of a numpy array on `device`; on a CUDA device from
    pinned memory, without waiting for the device."""
    arr = np.asarray(arr)
    if device.type != "cuda":
        return torch.tensor(arr, dtype=torch.float32)
    staged = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
    staged.numpy()[...] = arr
    return staged.to(device, non_blocking=True)


def fetch(*parts) -> np.ndarray:
    """The (n_i, k) tensors `parts` as one float32 numpy array
    (sum n_i, k): one transfer, the caller's only wait for the device."""
    return torch.cat([p.to(torch.float32) for p in parts]).cpu().numpy()


class KLTTracker:
    def __init__(
        self,
        intrinsics: np.ndarray,
        cam_model: int = 0,
        num_features: int = 150,
        grid: tuple = (8, 10),
        levels: int = 4,
        fast_thresh: float = 20.0,
        window_half: int = 7,
        cam_id: int = 0,
        histeq: str = "HISTOGRAM",
        device=None,
        generator: torch.Generator = None,
    ):
        self.device = resolve_device(device)
        self.intrinsics = torch.as_tensor(
            np.asarray(intrinsics), dtype=torch.float32, device=self.device
        )
        self.cam_model = cam_model
        self.cap = num_features
        self.grid = grid
        self.levels = levels
        self.fast_thresh = fast_thresh
        self.half = window_half
        self.cam_id = cam_id
        # image preprocessing (`TrackKLT.cpp:56-67`): the reference
        # equalizes unconditionally; HISTOGRAM runs on the device, CLAHE
        # on the host through cv2
        self.histeq = histeq

        # detection capacity per cell sized like the reference
        # (`Grider_FAST.h:73` num_features/grid, capped at 4): after mass
        # track loss the detector can refill the whole budget in one
        # frame instead of one corner per cell per frame
        self.per_cell = max(1, min(4, math.ceil(num_features / (grid[0] * grid[1]))))

        self.uv = np.zeros((self.cap, 2), np.float32)
        self.active = np.zeros(self.cap, bool)
        self.ids = np.full(self.cap, -1, np.int64)
        self.next_id = 0
        self.prev_img = None  # the previous frame, preprocessed, on the device
        self.prev_pyr = None  # and its pyramid
        self.generator = generator
        if generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(0)
        fx = float(intrinsics[0])
        fy = float(intrinsics[1])
        self.ransac_thresh = 2.0 / max(fx, fy)  # TrackKLT.cpp:873 convention

    def _fit_levels(self, img_shape):
        # coarsest pyramid level must still contain the LK window
        min_dim = min(img_shape)
        levels = self.levels
        while levels > 1 and min_dim // (2 ** (levels - 1)) < 2 * (self.half + 2):
            levels -= 1
        self.levels = levels

    # -- device side ----------------------------------------------------
    def _preprocess(self, img: np.ndarray):
        """(image, pyramid) on the device of a raw host frame, equalized
        as `histeq` says."""
        if self.histeq == "CLAHE":
            from .aruco import histogram_equalize

            img = histogram_equalize(np.asarray(img), "CLAHE")
        img_d = to_device(img, self.device)
        if self.histeq == "HISTOGRAM":
            img_d = hist_equalize(img_d)
        return img_d, build_pyramid(img_d, self.levels)

    def _detect(self, img_d, uv, occupied):
        score = fast_score(img_d, self.fast_thresh)
        return grid_detect(
            score, self.grid[0], self.grid[1], uv, occupied, per_cell=self.per_cell
        )

    def _track(self, pyr, uv, active, gumbel=None):
        """LK from the previous pyramid and RANSAC in normalized
        coordinates: (uv_new, ok, tracked)."""
        uv_new, ok = lk_track(self.prev_pyr, pyr, uv, active, half=self.half)
        # both point sets through the (iterative) undistortion in one call
        uvn = cam_models.undistort(self.intrinsics, self.cam_model, torch.cat([uv, uv_new]))
        n = uv.shape[0]
        inl = ransac_fundamental(
            uvn[:n], uvn[n:], ok & active, self.ransac_thresh, gumbel=gumbel, generator=self.generator
        )
        return uv_new, ok, active & ok & inl

    def _table(self):
        """The host's track table on the device: (uv (N,2), active (N,))."""
        tab = to_device(np.concatenate([self.uv, self.active[:, None]], axis=1), self.device)
        return tab[:, :2].contiguous(), tab[:, 2] != 0

    # -- host side ------------------------------------------------------
    def feed(self, t: float, img: np.ndarray, gumbel: torch.Tensor = None):
        """Process one image; returns (ids (N,), uvs (N,2)) of active
        tracks (including newly spawned ones). `gumbel`, (64, 8, N)
        float32 Gumbel noise, replaces the generator's draw in RANSAC."""
        if self.prev_img is None:
            self._fit_levels(img.shape)
        img_d, pyr = self._preprocess(img)
        uv, active = self._table()
        N = self.cap
        if self.prev_img is None:
            # initial detection only (same preprocessing as later frames)
            det_uv, det_ok = self._detect(img_d, uv, active)
            host = fetch(torch.cat([det_uv, det_ok[:, None]], dim=1))
        else:
            uv_new, _, tracked = self._track(pyr, uv, active, gumbel)
            # keep failed tracks' slots free; detect new corners in free cells
            det_uv, det_ok = self._detect(img_d, uv_new, tracked)
            host = fetch(
                torch.cat([uv_new, tracked[:, None]], dim=1),
                torch.cat([det_uv, det_ok[:, None]], dim=1),
            )
            self.uv = host[:N, :2].copy()
            self.active = host[:N, 2] != 0
            self.ids[~self.active] = -1
            host = host[N:]
        self._spawn(host[:, :2], host[:, 2] != 0)
        self.prev_img, self.prev_pyr = img_d, pyr
        return self._emit()

    def stereo_match(self, img_left, img_right, uv_left, valid, pyr_left=None):
        """LK-match features from the left image into the right image
        (TrackKLT::perform_matching stereo path, `TrackKLT.cpp:202-390`):
        left positions seed the right-image search; failures masked.
        `pyr_left`, the left image's pyramid where the caller has it
        (then `img_left` is not read), else it is built here.
        Returns (uv_right (N,2), ok (N,))."""
        if pyr_left is None:
            _, pyr_left = self._preprocess(img_left)
        _, pyr_right = self._preprocess(img_right)
        tab = to_device(
            np.concatenate([np.asarray(uv_left), np.asarray(valid)[:, None]], axis=1), self.device
        )
        uv_r, ok = lk_track(
            pyr_left, pyr_right, tab[:, :2].contiguous(), tab[:, 2] != 0, half=self.half
        )
        host = fetch(torch.cat([uv_r, ok[:, None]], dim=1))
        return host[:, :2].copy(), host[:, 2] != 0

    def _spawn(self, det_uv, det_ok):
        free = np.nonzero(~self.active)[0]
        new = np.nonzero(det_ok)[0]
        n = min(len(free), len(new))
        for i in range(n):
            slot = free[i]
            self.uv[slot] = det_uv[new[i]]
            self.active[slot] = True
            self.ids[slot] = self.next_id
            self.next_id += 1

    def _emit(self):
        sel = self.active
        return self.ids[sel].copy(), self.uv[sel].copy()

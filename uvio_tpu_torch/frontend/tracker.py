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

The device part of `feed` (preprocessing, LK, undistortion, RANSAC,
FAST, grid detection and the packing for the read-back) is
`_device_first` on a tracker's first frame and `_device_track` after,
`uvio_tpu`'s jitted `_device_step`; on the card each is captured once as
a CUDA graph and replayed (`graphs.graphed`, the port's `jax.jit` of
`_build_step`). `stereo_match`'s device part (the right image's pyramid
and LK from the left pyramid) is `step_stereo`, graphed the same way on
a table padded to the tracker's capacity, so one graph serves every
track count; `uvio_tpu` runs it op by op. `_fit_levels` fixes the
pyramid before any is captured. The host keeps the ids (`_spawn`, `_emit`), uploads the frame
and the track table, draws RANSAC's noise from the generator (an input
of the graph, so the draws are the eager path's) and, with
`histeq="CLAHE"`, equalizes on the host through cv2 before the upload.

On CUDA tensors one `feed` launches the `fast9` kernel once and the
`lk_track` kernel once, and `stereo_match` `lk_track` once, inside the
graphs (`kernels.launch_counts` counts them at each replay); on the CPU
the wrappers take their plain versions.

Each `feed` leaves its timing row in `last_timing`, as a manager does
(`tracing.py`): the host spans in s, `upload` (the frame and the track
table on their way to the device), `replay` (the noise drawn and the
graphed call made, to its return), `readback` (the wait for the device
and the one copy back), `spawn` (new ids and the emitted tracks) and
`track` (the whole `feed`, which they tile); the frame's counts from the
read-back, `n_tracked`, `n_lk_lost` (active tracks LK dropped),
`n_ransac_lost` (tracked by LK, rejected by RANSAC) and `n_spawned`; and
`capture_ms`, the graph's warm-up and capture when the frame's key was
new. With the tracing switch on when the tracker is built, the spans are
also `uvio/<name>` profiler ranges, and the graphs carry device marks
at the end of `preprocess` (equalization and pyramid), `lk`, `ransac`
(with the undistortion) and `detect` (FAST-9 and the grid), whose ms the
row's `device` holds. `last_readback` is the frame's packed read-back
as it came ([uv_new | tracked | LK ok] a slot, then [uv | ok | 0] a
detection; detections alone on a first frame).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import tracing
from ..cam import models as cam_models
from ..device import resolve_device
from ..graphs import graphed
from ..tracing import mark
from .klt import (
    RANSAC_HYPOTHESES,
    build_pyramid,
    fast_score,
    grid_detect,
    gumbel_noise,
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
        # the device part of `feed`, graphed (`.eager` is the plain one)
        self.step_first = graphed(self._device_first, "KLTTracker first frame")
        self.step_track = graphed(self._device_track, "KLTTracker tracking")
        self.step_stereo = graphed(self._device_stereo, "KLTTracker stereo match")
        # the tracing switch, read once (`tracing.py`)
        self.tracing = tracing.enabled()
        self._span = tracing.span_for(self.tracing)
        self.last_timing = None
        self.last_readback = None

    def _fit_levels(self, img_shape):
        # coarsest pyramid level must still contain the LK window
        min_dim = min(img_shape)
        levels = self.levels
        while levels > 1 and min_dim // (2 ** (levels - 1)) < 2 * (self.half + 2):
            levels -= 1
        self.levels = levels

    # -- device side ----------------------------------------------------
    def _upload(self, img: np.ndarray) -> torch.Tensor:
        """A raw host frame on the device, equalized on the host first
        when `histeq` is CLAHE."""
        if self.histeq == "CLAHE":
            from .aruco import histogram_equalize

            img = histogram_equalize(np.asarray(img), "CLAHE")
        return to_device(img, self.device)

    def _prepare(self, img_d: torch.Tensor):
        """(image, pyramid) of an uploaded frame, equalized on the device
        when `histeq` is HISTOGRAM."""
        if self.histeq == "HISTOGRAM":
            img_d = hist_equalize(img_d)
        return img_d, build_pyramid(img_d, self.levels)

    def _preprocess(self, img: np.ndarray):
        """(image, pyramid) on the device of a raw host frame, equalized
        as `histeq` says."""
        return self._prepare(self._upload(img))

    def _detect(self, img_d, uv, occupied):
        score = fast_score(img_d, self.fast_thresh)
        return grid_detect(
            score, self.grid[0], self.grid[1], uv, occupied, per_cell=self.per_cell
        )

    def _track(self, pyr, uv, active, gumbel=None, prev_pyr=None):
        """LK from the previous pyramid (`prev_pyr`, by default the
        tracker's) and RANSAC in normalized coordinates: (uv_new, ok,
        tracked)."""
        prev_pyr = self.prev_pyr if prev_pyr is None else prev_pyr
        uv_new, ok = lk_track(prev_pyr, pyr, uv, active, half=self.half)
        mark("lk")
        # both point sets through the (iterative) undistortion in one call
        uvn = cam_models.undistort(self.intrinsics, self.cam_model, torch.cat([uv, uv_new]))
        n = uv.shape[0]
        inl = ransac_fundamental(
            uvn[:n], uvn[n:], ok & active, self.ransac_thresh, gumbel=gumbel, generator=self.generator
        )
        return uv_new, ok, active & ok & inl

    @staticmethod
    def _columns(tab):
        """(uv (N,2), active (N,)) of an uploaded track table (N,3)."""
        return tab[:, :2].contiguous(), tab[:, 2] != 0

    def _upload_table(self) -> torch.Tensor:
        return to_device(np.concatenate([self.uv, self.active[:, None]], axis=1), self.device)

    def _table(self):
        """The host's track table on the device: (uv (N,2), active (N,))."""
        return self._columns(self._upload_table())

    def _device_first(self, img_d, tab):
        """The device part of a first `feed` (same preprocessing as later
        frames, then detection only): (pyramid, detections packed (G,3))."""
        img_e, pyr = self._prepare(img_d)
        mark("preprocess")
        uv, active = self._columns(tab)
        det_uv, det_ok = self._detect(img_e, uv, active)
        mark("detect")
        return pyr, torch.cat([det_uv, det_ok[:, None]], dim=1).to(torch.float32)

    def _device_track(self, prev_pyr, img_d, tab, gumbel):
        """The device part of a later `feed`: LK from `prev_pyr`, RANSAC
        with the noise `gumbel`, then detection in the cells that failed
        tracks left free: (pyramid, [uv_new | tracked | LK ok] (N,4) on
        top of the detections [uv | ok | 0] (G,4), packed)."""
        img_e, pyr = self._prepare(img_d)
        mark("preprocess")
        uv, active = self._columns(tab)
        uv_new, ok, tracked = self._track(pyr, uv, active, gumbel, prev_pyr=prev_pyr)
        mark("ransac")
        det_uv, det_ok = self._detect(img_e, uv_new, tracked)
        mark("detect")
        packed = torch.cat([torch.cat([uv_new, tracked[:, None], ok[:, None]], dim=1),
                            torch.cat([det_uv, det_ok[:, None], torch.zeros_like(det_ok[:, None])], dim=1)])
        return pyr, packed.to(torch.float32)

    def _device_stereo(self, pyr_left, img_d, tab):
        """The device part of `stereo_match`: the right image's pyramid, LK
        from `pyr_left` for the table's points, [uv_right | ok] (N,3)."""
        _, pyr_right = self._prepare(img_d)
        uv, valid = self._columns(tab)
        uv_r, ok = lk_track(pyr_left, pyr_right, uv, valid, half=self.half)
        return torch.cat([uv_r, ok[:, None]], dim=1).to(torch.float32)

    # -- host side ------------------------------------------------------
    def feed(self, t: float, img: np.ndarray, gumbel: torch.Tensor = None):
        """Process one image; returns (ids (N,), uvs (N,2)) of active
        tracks (including newly spawned ones). `gumbel`, (64, 8, N)
        float32 Gumbel noise, replaces the generator's draw in RANSAC.
        The frame's timing row is left in `last_timing` (module
        docstring)."""
        t0 = time.perf_counter()
        with self._span("track"):
            if self.prev_img is None:
                self._fit_levels(img.shape)
            with self._span("upload"):
                img_d, tab = self._upload(img), self._upload_table()
            t1 = time.perf_counter()
            N = self.cap
            n_active = int(self.active.sum())
            first = self.prev_img is None
            with self._span("replay"):
                if first:
                    step = self.step_first
                    pyr, packed = step(img_d, tab)
                else:
                    step = self.step_track
                    if gumbel is None:
                        gumbel = gumbel_noise((RANSAC_HYPOTHESES, 8, N), self.generator, self.device)
                    pyr, packed = step(self.prev_pyr, img_d, tab, gumbel)
            t2 = time.perf_counter()
            with self._span("readback"):
                host = self.last_readback = packed.cpu().numpy()
            t3 = time.perf_counter()
            with self._span("spawn"):
                if first:
                    n_tracked = n_lk_lost = n_ransac_lost = 0
                else:
                    self.uv = host[:N, :2].copy()
                    self.active = host[:N, 2] != 0
                    self.ids[~self.active] = -1
                    n_tracked = int(self.active.sum())
                    n_ok = int(np.count_nonzero(host[:N, 3]))
                    n_lk_lost, n_ransac_lost = n_active - n_ok, n_ok - n_tracked
                    host = host[N:]
                n_spawned = self._spawn(host[:, :2], host[:, 2] != 0)
                self.prev_img, self.prev_pyr = pyr[0], pyr
                out = self._emit()
            t4 = time.perf_counter()
        row = {"t_start": t0, "upload": t1 - t0, "replay": t2 - t1, "readback": t3 - t2, "spawn": t4 - t3,
               "track": t4 - t0, "n_tracked": n_tracked, "n_lk_lost": n_lk_lost,
               "n_ransac_lost": n_ransac_lost, "n_spawned": n_spawned,
               "capture_ms": getattr(step, "last_capture_ms", 0.0)}
        if self.tracing:
            timed = step.take_timed()
            if timed:  # replays on the card, the stream waited for by the read-back
                row["device"] = tracing.stage_ms(*timed[-1])
        self.last_timing = row
        return out

    def stereo_match(self, img_left, img_right, uv_left, valid, pyr_left=None):
        """LK-match features from the left image into the right image
        (TrackKLT::perform_matching stereo path, `TrackKLT.cpp:202-390`):
        left positions seed the right-image search; failures masked.
        `pyr_left`, the left image's pyramid where the caller has it
        (then `img_left` is not read), else it is built here.
        The N points go in padded with invalid rows to the tracker's
        capacity (LK treats each point alone, so the real rows are those of
        the unpadded call) and come back in one read-back.
        Returns (uv_right (N,2), ok (N,))."""
        if pyr_left is None:
            _, pyr_left = self._preprocess(img_left)
        n = len(uv_left)
        tab = np.zeros((max(n, self.cap), 3), np.float32)
        tab[:n, :2] = uv_left
        tab[:n, 2] = valid
        host = self.step_stereo(pyr_left, self._upload(img_right), to_device(tab, self.device)).cpu().numpy()[:n]
        return host[:, :2].copy(), host[:, 2] != 0

    def _spawn(self, det_uv, det_ok) -> int:
        """New tracks from the detections in free slots; returns how many."""
        free = np.nonzero(~self.active)[0]
        new = np.nonzero(det_ok)[0]
        n = min(len(free), len(new))
        for i in range(n):
            slot = free[i]
            self.uv[slot] = det_uv[new[i]]
            self.active[slot] = True
            self.ids[slot] = self.next_id
            self.next_id += 1
        return n

    def _emit(self):
        sel = self.active
        return self.ids[sel].copy(), self.uv[sel].copy()

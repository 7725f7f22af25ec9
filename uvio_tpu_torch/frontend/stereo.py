"""Stereo KLT tracking.

Port of `uvio_tpu/frontend/stereo.py`, the equivalent of the reference's
`TrackKLT::feed_stereo` (`TrackKLT.cpp:202-390`): temporal KLT in the
left camera, then left-to-right LK matching per frame with the SAME
feature ids, so both cameras' observations land in the database under
one feature, which is what gives the estimator its instantaneous stereo
baseline constraint.

The left image's pyramid is the one the temporal tracker just built
(`KLTTracker.prev_pyr`), so a `feed` on CUDA tensors launches `fast9`
once and `lk_track` twice. The left<->right RANSAC draws from its own
`torch.Generator` (seeded 1 unless one is given).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cam import models as cam_models
from .klt import ransac_fundamental
from .tracker import KLTTracker, fetch, to_device


class StereoKLTTracker:
    """Tracks temporally in cam0 and matches into cam1 each frame.

    `feed(t, img_left, img_right)` returns the per-camera observation
    list the manager consumes: [(ids, uvs_left), (ids_r, uvs_right)].
    """

    def __init__(self, intrinsics_left, intrinsics_right, cam_model=0,
                 stereo_generator: torch.Generator = None, **kw):
        self.left = KLTTracker(intrinsics_left, cam_model, cam_id=0, **kw)
        self.intrinsics_right = torch.as_tensor(
            np.asarray(intrinsics_right), dtype=torch.float32, device=self.left.device
        )
        self.generator = stereo_generator
        if stereo_generator is None:
            self.generator = torch.Generator(device=self.left.device).manual_seed(1)

    def feed(self, t: float, img_left: np.ndarray, img_right: np.ndarray,
             gumbel: torch.Tensor = None, stereo_gumbel: torch.Tensor = None):
        """`gumbel` goes to the temporal RANSAC (`KLTTracker.feed`),
        `stereo_gumbel`, (64, 8, number of active tracks), to the
        left<->right one."""
        left = self.left
        ids, uvs = left.feed(t, img_left, gumbel=gumbel)
        if len(ids) == 0:
            return [(ids, uvs), (ids, uvs)]
        # match active left features into the right image
        sel_uv = left.uv[left.active]
        sel_ids = left.ids[left.active]
        uv_r, ok = left.stereo_match(
            img_left, img_right, sel_uv, np.ones(len(sel_uv), bool), pyr_left=left.prev_pyr
        )
        # RANSAC on the left<->right correspondences (the reference runs
        # an 8-pt RANSAC over the right-camera matches too,
        # `TrackKLT.cpp:202-390`; its check is temporal t-1 -> t in the
        # right camera; ours re-matches from the left every frame, so
        # the left<->right epipolar check is the analogous gate)
        if ok.sum() >= 12:
            dev = left.device
            uvn_l = cam_models.undistort(left.intrinsics, left.cam_model, to_device(sel_uv, dev))
            uvn_r = cam_models.undistort(self.intrinsics_right, left.cam_model, to_device(uv_r, dev))
            inl = ransac_fundamental(
                uvn_l, uvn_r, to_device(ok, dev) != 0, left.ransac_thresh,
                gumbel=stereo_gumbel, generator=self.generator,
            )
            ok = ok & (fetch(inl[:, None])[:, 0] != 0)
        ids_r = sel_ids[ok]
        uvs_r = uv_r[ok]
        return [(ids, uvs), (ids_r, uvs_r)]

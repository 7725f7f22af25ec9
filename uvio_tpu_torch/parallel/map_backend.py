"""Keyframe map backend: the VIO -> BA integration.

Port of `uvio_tpu/parallel/map_backend.py`. The filter is the realtime
frontend; this backend accumulates decimated keyframes (cam-0 clone
poses) and normalized feature observations from the live `VioManager`,
and refines a global keyframe map with the bundle adjustment of
`parallel/ba.py` (sharded when given a mesh). The reference's closest
analog is the loop-closure export its estimator publishes for an external
consumer (`VioManager::publish_loopclosure_information`,
`VioManagerHelper.cpp:190-387`), which is the data this class consumes.

Refinement is one-way (the VIO state is never written back). The map
lives on the host as numpy; `refine()` pads it to static buckets (the
keyframe axis to `max_keyframes`, landmarks to a multiple of
`lm_bucket`) and solves on `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cam import models as cam_models
from ..device import resolve_device
from ..math import quat_to_rot, rot_to_quat
from ..update.msckf import clone_camera_poses
from ..update.triangulation import triangulate_batch
from .ba import BAOptions, ba_solve


@dataclasses.dataclass
class MapBackendOptions:
    every_n_frames: int = 4  # keyframe decimation of the VIO frame rate
    min_obs: int = 3  # landmark must be seen in >= this many keyframes
    max_keyframes: int = 64  # static keyframe capacity
    lm_bucket: int = 128  # landmark axis padded to a multiple of this
    ba: BAOptions = dataclasses.field(default_factory=lambda: BAOptions(iters=10))


class MapBackend:
    """Accumulate keyframes + tracks from a VioManager; refine with BA.

    Usage::

        backend = MapBackend(device=mgr.device)  # mesh= for a sharded solve
        ...
        mgr.feed_features(t, obs)
        backend.ingest(mgr)                      # after each frame
        ...
        result = backend.refine()                # periodically / at end

    `device` is where `refine()` solves: None is `default_device()`
    (cuda:0 or an error), "cpu" the CPU.
    """

    def __init__(self, opts: Optional[MapBackendOptions] = None, mesh=None, device=None):
        self.opts = opts or MapBackendOptions()
        self.mesh = mesh
        self.device = resolve_device(device)
        self.kf_t: list = []
        self.kf_q: list = []  # JPL q_GtoC, cam 0
        self.kf_p: list = []  # p_CinG
        self.obs: dict = {}  # fid -> {kf_idx: (un, vn) normalized}
        self._frame_count = 0
        self.refined: Optional[dict] = None

    # ------------------------------------------------------------------
    def ingest(self, mgr) -> bool:
        """Pull the newest frame from a VioManager: cam-0 clone pose and
        normalized observations of every feature seen at that frame.
        Call after each `feed_features`; frames are decimated by
        `every_n_frames` and capped at `max_keyframes`. Reads the pose
        back once and the undistorted observations once per keyframe.
        """
        t = mgr._last_frame_t
        if t is None or not mgr.is_initialized:
            return False
        self._frame_count += 1
        if (self._frame_count - 1) % self.opts.every_n_frames:
            return False
        slot = next((s for s, tt in mgr.slot_times.items() if tt == t), None)
        if slot is None:
            return False
        if len(self.kf_t) >= self.opts.max_keyframes:
            self._evict()

        (R, p), _ = clone_camera_poses(mgr.state, mgr.layout)
        pose = torch.cat([rot_to_quat(R[slot, 0]), p[slot, 0]]).cpu().numpy()
        kf_idx = len(self.kf_t)
        self.kf_t.append(t)
        self.kf_q.append(pose[:4])
        self.kf_p.append(pose[4:])

        uvs, fids = [], []
        for f in mgr.db.features_seen_at(t):
            for (tt, u, v) in f.obs.get(0, []):
                if abs(tt - t) < 1e-9:
                    uvs.append((u, v))
                    fids.append(f.feat_id)
                    break
        if uvs:
            f64 = torch.float64
            intr = mgr.state.calib_cam_intr[0].to(f64)
            uvn = cam_models.undistort(
                intr, mgr.cfg.cameras[0].model, torch.as_tensor(np.asarray(uvs), dtype=f64, device=intr.device)
            ).cpu().numpy()
            for fid, uv in zip(fids, uvn):
                self.obs.setdefault(fid, {})[kf_idx] = uv
        return True

    # ------------------------------------------------------------------
    def _evict(self):
        """Make room for a new keyframe: temporal decimation.

        Victim = the keyframe (excluding the first and the newest few)
        whose neighbors are closest in time: removing it loses the least
        temporal coverage, so the map keeps its full span while the oldest
        region thins out. Its observations are dropped and the remaining
        keyframes reindexed; landmarks left with no observation are
        deleted.
        """
        N = len(self.kf_t)
        if N < 3:
            return
        # keep the map anchor (index 0) and the freshest 25% intact
        hi = max(2, int(N * 0.75))
        gaps = [(self.kf_t[i + 1] - self.kf_t[i - 1], i) for i in range(1, hi)]
        _, victim = min(gaps)
        self.kf_t.pop(victim)
        self.kf_q.pop(victim)
        self.kf_p.pop(victim)
        dead = []
        for fid, o in self.obs.items():
            o.pop(victim, None)
            self.obs[fid] = {(k - 1 if k > victim else k): uv for k, uv in o.items()}
            if not self.obs[fid]:
                dead.append(fid)
        for fid in dead:
            del self.obs[fid]

    @property
    def num_keyframes(self) -> int:
        return len(self.kf_t)

    def _packed(self):
        """Static-shape (q, p, pose_valid, lm0, obs_uv, obs_mask, fids, ok)
        as numpy."""
        N = len(self.kf_t)
        Np = self.opts.max_keyframes
        fids = sorted(fid for fid, o in self.obs.items() if len(o) >= self.opts.min_obs)
        L = len(fids)
        b = self.opts.lm_bucket
        Lp = max(b, ((L + b - 1) // b) * b)

        q = np.tile([0.0, 0.0, 0.0, 1.0], (Np, 1))
        p = np.zeros((Np, 3))
        q[:N] = np.asarray(self.kf_q)
        p[:N] = np.asarray(self.kf_p)
        valid = np.zeros(Np, bool)
        valid[:N] = True

        uv = np.zeros((Lp, Np, 2))
        mask = np.zeros((Lp, Np), bool)
        for i, fid in enumerate(fids):
            for k, o in self.obs[fid].items():
                uv[i, k] = o
                mask[i, k] = True

        on = lambda x, dtype=torch.float64: torch.as_tensor(x, dtype=dtype, device=self.device)
        lm0, ok = triangulate_batch(on(uv), on(mask, torch.bool), quat_rots(on(q)), on(p))
        lm0, ok = lm0.cpu().numpy(), ok.cpu().numpy()
        # landmarks that fail triangulation are dropped (mask cleared)
        mask[~ok] = False
        return q, p, valid, lm0, uv, mask, fids, ok

    def refine(self) -> Optional[dict]:
        """Run the (mesh-sharded) BA over the accumulated map.

        Returns {"kf_t", "kf_q", "kf_p", "points": {fid: p_FinG},
        "costs"} as numpy, or None if the map is too small. Also cached
        on `self.refined`.
        """
        if len(self.kf_t) < 2 or not self.obs:
            return None
        q, p, valid, lm0, uv, mask, fids, ok = self._packed()
        if not mask.any():
            return None
        on = lambda x, dtype=torch.float64: torch.as_tensor(x, dtype=dtype, device=self.device)
        qr, pr, lmr, info = ba_solve(
            on(q), on(p), on(lm0), on(uv), on(mask, torch.bool), self.opts.ba,
            mesh=self.mesh, pose_valid=on(valid, torch.bool),
        )
        N = len(self.kf_t)
        lmr = lmr.cpu().numpy()
        self.refined = {
            "kf_t": np.asarray(self.kf_t),
            "kf_q": qr.cpu().numpy()[:N],
            "kf_p": pr.cpu().numpy()[:N],
            "points": {fid: lmr[i] for i, fid in enumerate(fids) if ok[i]},
            "costs": info["costs"].cpu().numpy(),
        }
        return self.refined


def quat_rots(q):
    """(..., 4) JPL quaternions -> (..., 3, 3) rotations, as tensors."""
    return quat_to_rot(torch.as_tensor(q))

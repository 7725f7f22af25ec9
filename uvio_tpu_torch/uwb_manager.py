"""UVIO manager: UWB-aided VIO with bias-compensated anchors.

Port of `uvio_tpu/uwb_manager.py` (the reference's
`uvio/src/core/UVioManager.{h,cpp}`):

  * anchor seeding from config with 5x5 prior covariances (fixed anchors
    get zero covariance and are thus not estimated), `UVioManager.cpp:
    207-306`;
  * `feed_measurement_uwb` buffering with gates (VIO initialized,
    anchors initialized, min-distance, out-of-order drop),
    `UVioManager.cpp:61-76`;
  * drain of buffered ranges older than the image time *before* the
    visual update, each range applied by propagate-to-timestamp WITHOUT
    cloning (`UVioPropagator`) + per-range chi2-gated single update
    (`do_uwb_propagate_update`, `UVioManager.cpp:308-344`): inside the
    frame's step for up to `max_uwb_sets_per_frame` sets, and set by set
    from the host on the staged path or when more are buffered, each set
    one replay of the graphed `_stage_prop_only` and one of `_stage_uwb`
    (`uvio_tpu`'s `_jit_prop_only` and `_jit_uwb`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from .filter.ekf import set_block_covariance
from .filter.propagator import propagate_mean_cov
from .manager import VioConfig, VioManager, _stage
from .update.uwb import uwb_update
from .utils.logger import print_warning


@dataclasses.dataclass
class AnchorConfig:
    anchor_id: int
    p_AinG: np.ndarray
    gamma: float = 0.0  # constant range bias
    alpha: float = 0.0  # distance-proportional bias
    fix: bool = False  # fixed anchors are not estimated
    prior_cov: Optional[np.ndarray] = None  # (5,5); None -> default diag


@dataclasses.dataclass
class UVioConfig(VioConfig):
    max_anchors: int = 8
    anchors: List[AnchorConfig] = dataclasses.field(default_factory=list)
    sigma_range: float = 0.1
    uwb_chi2_mult: float = 1.0
    min_dist_to_use_uwb: float = 0.0
    calib_uwb_extrinsics: bool = False
    p_IinU: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    p_IinU_prior_std: float = 0.03
    # max buffered range-sets drained inside the per-frame step
    # (overflow falls back to the host's drain before the step)
    max_uwb_sets_per_frame: int = 4


class UVioManager(VioManager):
    def _layout_extras(self) -> dict:
        # anchor slots + the UWB-IMU lever-arm calib state join the
        # layout BEFORE the base ctor builds state and priors, so every
        # base-config option (slam_rep, imu intrinsics, integration,
        # calib seeds + priors) survives intact (UVioManager.cpp:26-55
        # extends the base state the same way).
        return dict(
            max_anchors=self.ucfg.max_anchors,
            calib_uwb_extrinsics=self.ucfg.calib_uwb_extrinsics,
        )

    def __init__(self, cfg: UVioConfig):
        self.ucfg = cfg
        super().__init__(cfg)
        # seed the UWB-IMU lever arm (base init_state zeroes it)
        self.state = self.state.replace(uwb_p_IinU=self._on(cfg.p_IinU))
        self.anchor_slot_by_id: Dict[int, int] = {}
        self.uwb_buffer: List = []  # (t, {aid: dist})
        self._last_uwb_t = -np.inf
        self.anchors_initialized = False
        self._stage_prop_only = _stage(partial(propagate_mean_cov, layout=self.layout, noises=cfg.noises,
                                               gravity_mag=cfg.gravity_mag, integration=cfg.integration),
                                       "propagate_mean_cov")
        self._stage_uwb = _stage(partial(uwb_update, layout=self.layout, sigma_range=cfg.sigma_range,
                                         chi2_mult=cfg.uwb_chi2_mult), "uwb_update")
        if cfg.anchors:
            self.initialize_anchors(cfg.anchors)

    # ------------------------------------------------------------------
    def _full_step_extras(self) -> dict:
        return dict(
            uwb_sets_per_frame=self.ucfg.max_uwb_sets_per_frame,
            sigma_range=self.ucfg.sigma_range,
            uwb_chi2_mult=self.ucfg.uwb_chi2_mult,
        )

    def _collect_uwb_sets(self, t_img: float):
        """Eligible range-sets for the in-step drain. If more are buffered
        than the step's static capacity, drain everything from the host
        instead (rare)."""
        eligible = [(t_u, r) for (t_u, r) in self.uwb_buffer if t_u < t_img]
        if len(eligible) > self.ucfg.max_uwb_sets_per_frame:
            self._pre_visual_update(t_img)  # moves the state forward
            return []
        return eligible

    def _consume_uwb_sets(self, sets):
        if sets:
            consumed_ts = {t_u for (t_u, _) in sets}
            self.uwb_buffer = [(t_u, r) for (t_u, r) in self.uwb_buffer if t_u not in consumed_ts]

    # ------------------------------------------------------------------
    def _async_eligible(self) -> bool:
        """`feed_uwb` gates ingestion on the traveled distance
        (`UVioManager.cpp:64-67`), and distance is only accumulated when
        a frame reads the position back. Stay on the sync path until the
        gate is permanently open: distance is monotone non-decreasing, so
        once passed async can never starve the UWB ingestion again (the
        periodic read-back keeps the mirror fresh afterwards)."""
        return not self.anchors_initialized or self.distance > self.ucfg.min_dist_to_use_uwb

    # ------------------------------------------------------------------
    def initialize_anchors(self, anchors: List[AnchorConfig]):
        """Insert anchors with prior covariance (initialize_new_uwb_anchor
        equivalent; supports late additions for runtime-initialized
        anchors, `UVioManager.cpp:78-112`)."""
        st = self.state
        # one download and one upload of the small anchor blocks per call,
        # instead of a host write into a device tensor per anchor and field
        p, gamma, alpha, valid = (
            x.cpu().numpy().copy()
            for x in (st.anchors_p, st.anchors_gamma, st.anchors_alpha, st.anchors_valid)
        )
        cov = st.cov
        for a in anchors:
            if a.anchor_id in self.anchor_slot_by_id:
                continue
            slot = len(self.anchor_slot_by_id)
            if slot >= self.ucfg.max_anchors:
                raise ValueError("more anchors than max_anchors slots")
            self.anchor_slot_by_id[a.anchor_id] = slot
            p[slot], gamma[slot], alpha[slot], valid[slot] = a.p_AinG, a.gamma, a.alpha, True
            if a.fix:
                block = np.zeros((5, 5))
            elif a.prior_cov is not None:
                block = np.asarray(a.prior_cov)
            else:
                block = np.diag([0.04, 0.04, 0.04, 0.01, 1e-4])
            # (the block is cast to the covariance's dtype: a float64 prior
            # goes into a float32 state)
            cov = set_block_covariance(cov, self.layout.anchor_slot_off(slot), block)
        # uwb extrinsic prior
        if self.ucfg.calib_uwb_extrinsics:
            blk = np.eye(3) * self.ucfg.p_IinU_prior_std**2
            cov = set_block_covariance(cov, self.layout.calib_uwb_off, blk)
        self.state = st.replace(
            anchors_p=self._on(p), anchors_gamma=self._on(gamma), anchors_alpha=self._on(alpha),
            anchors_valid=self._on(valid, torch.bool), cov=cov,
        )
        self.anchors_initialized = True

    # ------------------------------------------------------------------
    def feed_anchors(self, anchors: List[AnchorConfig], n_fix: Optional[int] = None):
        """Runtime anchor initialization (the `/uwb_init/anchors`
        callback path, `UVIOROS1Visualizer.cpp:197-235`): sort received
        anchors by prior-covariance determinant, fix the best `n_fix`,
        insert the rest as estimated states. Supports late additions."""
        fresh = [a for a in anchors if a.anchor_id not in self.anchor_slot_by_id]
        if not fresh:
            return

        def detcov(a):
            return np.linalg.det(a.prior_cov) if a.prior_cov is not None else np.inf

        fresh = sorted(fresh, key=detcov)
        if n_fix:
            for a in fresh[:n_fix]:
                a.fix = True
        self.initialize_anchors(fresh)

    # ------------------------------------------------------------------
    def feed_uwb(self, t: float, ranges: Dict[int, float]):
        """Buffer a range set (feed_measurement_uwb gates: VIO
        initialized AND anchors initialized AND *traveled distance*
        above threshold, `UVioManager.cpp:64-67`; min_dist_to_use_uwb
        gates the vehicle's accumulated path length, not the range
        magnitude)."""
        if not (
            self.is_initialized
            and self.anchors_initialized
            and self.distance > self.ucfg.min_dist_to_use_uwb
        ):
            return
        if t <= self._last_uwb_t:
            # out-of-order: warn + drop (`UVioManager.cpp:70-73`)
            print_warning("uwb range at t=%.6f is out of order: dropped", t)
            return
        good = {aid: d for aid, d in ranges.items() if aid in self.anchor_slot_by_id}
        if good:
            self.uwb_buffer.append((t, good))
            self._last_uwb_t = t

    # ------------------------------------------------------------------
    def _pre_visual_update(self, t_img: float):
        """Drain buffered UWB sets older than the image, each by
        propagate-without-clone + per-range updates."""
        A = self.ucfg.max_anchors
        remaining = []
        for (t_u, ranges) in self.uwb_buffer:
            # strictly older than the image (UVioManager.cpp:178-188);
            # equal-time ranges wait for the next frame
            if t_u >= t_img:
                remaining.append((t_u, ranges))
                continue
            if t_u > self._time_host:
                # offset-shifted IMU window, camera-clock stamp: the
                # reference's UVioPropagator shares last_prop_time_offset
                # with the base propagator (UVioPropagator.cpp:80-100)
                tt, ww, aa, dt_now = self._select_imu_window(t_u)
                self.state, _ = self._stage_prop_only(self.state, **self._window(tt, ww, aa, t_u))
                self._time_host = float(t_u)
                self._last_prop_dt = dt_now
            r = np.zeros(A)
            m = np.zeros(A, bool)
            for aid, dist in ranges.items():
                slot = self.anchor_slot_by_id[aid]
                r[slot] = dist
                m[slot] = True
            self.state, info = self._stage_uwb(self.state, ranges=self._host(r), range_mask=self._host(m, torch.bool))
            self.last_uwb_info = info
        self.uwb_buffer = remaining

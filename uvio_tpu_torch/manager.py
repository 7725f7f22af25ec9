"""VIO manager: host orchestration around the per-frame device step.

Port of `uvio_tpu/manager.py` (the reference's
`ov_msckf/src/core/VioManager.{h,cpp}`): builds the layout and state,
buffers IMU, ingests feature tracks (the simulator's tracker or a real
frontend), and runs one frame of `do_feature_propagate_update`
(`VioManager.cpp:323-714`):

    [ZUPT attempt] -> [UWB drain] -> propagate+clone -> feature triage
    -> MSCKF update -> SLAM update/init -> marginalize oldest clone

Two paths run it. The fused path (`fused_step=True`, the default) is one
call of `pipeline.full_filter_step`, on the card one replay of a CUDA
graph captured once per `FramePlan` (`pipeline.make_packed_full_step`):
host work per frame is O(features) dict bookkeeping and the padded numpy
`FrameBundle`; the bundle goes to the device in one transfer, packed into
one pinned buffer that is copied straight into the graph's static input
(`pipeline.pack_bundle`), and the host reads the frame's decisions back
in one (`_fetch`). With `async_dispatch`
and nothing for the host to decide, a frame reads nothing back at all.
The staged path (`fused_step=False`) calls each stage on its own
(`_stage_*`, `uvio_tpu`'s `_jit_*`: each one graphed callable, on the card
one replay of a CUDA graph captured once per input shape, `_stage`) and
reads each stage's decisions back before the next, as `uvio_tpu`'s staged
path does; it times every stage (`last_timing`: host times, or with
tracing on the device times of each stage's graph replays). A stage's
inputs from the host (IMU windows, padded observations, slots) go in as
host tensors, pinned on the card, which the replay copies into the graph
without waiting; a slot is a tensor, so one graph serves every slot value.

The clone window uses `max_clones + 1` ring slots: the reference lets the
window grow to N+1 between `augment_clone` and the end-of-update
marginalization (`VioManager.cpp:584-597`); the extra slot gives the same
semantics with static shapes.

Each frame leaves its timing row in `last_timing` (`_record_fused_timing`,
`_frame_staged`): host spans by `time.perf_counter` and, with tracing on
(`tracing.py`, read once when the manager is built), the same spans as
`uvio/<name>` ranges on the profiler's clock and the device ms of the
frame's graphs.
"""

from __future__ import annotations

import dataclasses
import time as _time
import warnings
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .cam import RADTAN
from .cam import models as cam_models
from .device import resolve_device
from .filter.ekf import augment_clone, marginalize_clone, marginalize_slam, set_block_covariance
from .filter.propagator import (
    NoiseManager,
    propagate_and_clone,
    propagate_mean_only,
    select_imu_readings_np,
)
from .frontend.database import FeatureDatabase
from .frontend.fused_vio import check_full_precision
from . import tracing
from .graphs import Graphed, graphed
from .init.dynamic_init import DynamicInitOptions, result_to_state_first, solve_dynamic_init
from .init.static_init import StaticInitOptions, try_static_init
from .math import quat_to_rot
from .pipeline import FullStepConfig, make_packed_full_step, pack_bundle, plan_frame
from .types.layout import StateLayout
from .types.state import FilterState, init_state
from .update.msckf import clone_camera_poses, msckf_update
from .update.representations import anchor_change, landmark_global
from .update.slam import slam_delayed_init, slam_update
from .update.triangulation import triangulate_batch
from .update.zupt import zupt_explicit_update, zupt_try_update
from .utils.checkpoint import load_state, save_state
from .utils.logger import print_warning


@dataclasses.dataclass
class CameraConfig:
    model: int = RADTAN
    intrinsics: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([458.0, 458.0, 367.0, 248.0, 0, 0, 0, 0.0])
    )
    q_ItoC: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0, 0, 1]))
    p_IinC: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))


@dataclasses.dataclass
class VioConfig:
    max_clones: int = 11
    max_slam: int = 0
    feat_rep_slam: int = 1  # representations.ANCHORED_MSCKF_INVERSE_DEPTH
    # delay (s) after initialization before SLAM features may be
    # initialized: prevents a bad first set of FEJ-frozen landmarks
    # (`dt_slam_delay` yaml key, VioManager.cpp:443-444)
    dt_slam_delay: float = 2.0
    max_msckf_in_update: int = 40
    max_slam_init_per_frame: int = 8
    slam_fail_marg: int = 2  # chi2 failures before landmark marginalization
    max_imu_batch: int = 64
    # mean/covariance integration method: "discrete" | "rk4" | "analytical"
    # (StateOptions::IntegrationMethod; rk4 and analytical share the
    # closed-form ACI2 F/G like the reference)
    integration: str = "rk4"
    gravity_mag: float = 9.81
    sigma_pix: float = 1.0
    chi2_mult: float = 1.0
    noises: NoiseManager = dataclasses.field(default_factory=NoiseManager)
    cameras: List[CameraConfig] = dataclasses.field(default_factory=lambda: [CameraConfig()])
    calib_cam_pose: bool = False
    calib_cam_intrinsics: bool = False
    calib_cam_timeoffset: bool = False
    # camera-IMU time offset seed value (`calib_camimu_dt` yaml key)
    camimu_dt: float = 0.0
    # IMU intrinsic calibration (StateOptions do_calib_imu_intrinsics /
    # do_calib_imu_g_sensitivity / imu_model, `StateOptions.h:41-56`)
    calib_imu_intrinsics: bool = False
    calib_imu_g_sensitivity: bool = False
    imu_model: int = 0  # 0 = kalibr, 1 = rpng
    # seed values (None = perfect/identity); 6-vec dw/da, 9-vec tg, quats
    imu_dw: np.ndarray = None
    imu_da: np.ndarray = None
    imu_tg: np.ndarray = None
    imu_gq: np.ndarray = None
    imu_aq: np.ndarray = None
    # compute precision for everything except the time axis
    dtype: str = "float64"
    # prior std-devs for online calibration states (when enabled):
    # the reference's startup covariance (`State.cpp:134-163`)
    calib_pose_prior_rot: float = 0.005  # rad (State.cpp:154)
    calib_pose_prior_pos: float = 0.015  # m (State.cpp:156)
    calib_intr_prior: float = 1.0  # focal/center px (State.cpp:161)
    calib_dist_prior: float = 0.005  # distortion coeffs (State.cpp:163)
    calib_dt_prior: float = 0.01  # s (State.cpp:150)
    calib_imu_dw_prior: float = 0.005  # Dw entries (State.cpp:138)
    calib_imu_da_prior: float = 0.008  # Da entries (State.cpp:139)
    calib_imu_tg_prior: float = 0.005  # g-sensitivity (State.cpp:141)
    calib_imu_th_prior: float = 0.005  # gyro/acc frame rot (State.cpp:144)
    # initialization
    use_static_init: bool = False
    init_options: StaticInitOptions = dataclasses.field(default_factory=StaticInitOptions)
    init_max_disparity: float = 10.0  # px, stillness check for no-jerk init
    use_dynamic_init: bool = False  # init_dyn_use
    dyn_init_options: Optional[DynamicInitOptions] = None
    # zero-velocity update
    try_zupt: bool = False
    zupt_chi2_mult: float = 1.0
    zupt_noise_mult: float = 10.0
    zupt_max_velocity: float = 0.1
    zupt_max_disparity: float = 0.5
    zupt_only_at_beginning: bool = False
    # explicit zero-motion clone-pair constraint variant
    # (`UpdaterZeroVelocity.cpp:283-330`)
    zupt_explicit: bool = False
    # run the whole frame (UWB drain + ZUPT + propagate/clone + MSCKF +
    # SLAM + marginalize) as ONE device step (pipeline.full_filter_step).
    # False = the staged path with one call and a host read-back per
    # stage (kept for per-stage timing/debugging).
    fused_step: bool = True
    # defer device synchronization in the per-frame step: dispatch and
    # return without fetching results, so the host builds the next bundle
    # while the device works. Effective only when no host decision depends
    # on the frame's device results: max_slam == 0, try_zupt False, the
    # UWB distance gate open; otherwise the frame takes the synchronous
    # path. cov-health is checked on every 32nd frame, and the traveled
    # distance and the dt mirror refresh there.
    async_dispatch: bool = False
    # action on a corrupted covariance after an update (negative
    # diagonal or NaN): "raise" mirrors the reference's hard exit
    # (`StateHelper.cpp:102-113`), "warn" logs and keeps filtering,
    # "ignore" is silent.
    on_cov_fail: str = "raise"
    # where the state lives: None is `uvio_tpu_torch.default_device()`,
    # cuda:0 or an error; "cpu" for the CPU
    device: Optional[str] = None


def _stage(fn, name: str):
    """`fn(state, **inputs)` as one graphed stage (`graphs.graphed`, the
    port's `jax.jit`). Its inputs may be host tensors: a replay copies
    them into the graph's static inputs, and the body copies them to the
    state's device itself when it runs eagerly (`.eager`; a no-op inside
    the graph, whose inputs are on the card already)."""

    def body(state, **inputs):
        dev = state.cov.device
        return fn(state, **{k: v.to(dev, non_blocking=True) if isinstance(v, torch.Tensor) else v
                            for k, v in inputs.items()})

    # a manager whose stages were swapped for their `.eager` still runs
    # its init replays, which call `.eager`
    body.eager = body
    return graphed(body, name)


class CovarianceError(RuntimeError):
    """Covariance diagonal went negative/NaN after an update: the filter
    state is corrupted (the reference exits the process here,
    `StateHelper::EKFUpdate`, `StateHelper.cpp:102-113`)."""


# frames between the deferred covariance checks of the async path
_ASYNC_CHECK_EVERY = 32

# the staged path's stages: (timing CSV column, device stage, the graphed
# stages it replays)
_STAGED = (
    ("uwb", "uwb_drain", ("_stage_prop_only", "_stage_uwb")),
    ("propagation", "propagate_clone", ("_stage_prop",)),
    ("msckf", "msckf", ("_stage_msckf",)),
    ("slam", "slam", ("_stage_slam_up", "_stage_slam_init", "_stage_marg_slam")),
    ("marginalization", "marginalize", ("_stage_anchor_change", "_stage_marg")),
)


def _take_timed(g) -> list:
    """The timed replays of a graphed callable since last taken
    (`graphs.Graphed.take_timed`); none for a plain function."""
    take = getattr(g, "take_timed", None)
    return take() if take is not None else []


class VioManager:
    def _layout_extras(self) -> dict:
        """Extra StateLayout kwargs contributed by subclasses (the UWB
        manager adds anchor slots and the lever-arm calib state), so the
        layout is built once (`UVioManager.cpp:26-55`)."""
        return {}

    def __init__(self, cfg: VioConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.dtype = getattr(torch, cfg.dtype)
        self.integration = cfg.integration
        self.layout = StateLayout(
            max_clones=cfg.max_clones + 1,
            max_slam=cfg.max_slam,
            num_cams=len(cfg.cameras),
            calib_cam_timeoffset=cfg.calib_cam_timeoffset,
            calib_cam_pose=cfg.calib_cam_pose,
            calib_cam_intrinsics=cfg.calib_cam_intrinsics,
            calib_imu_intrinsics=cfg.calib_imu_intrinsics,
            calib_imu_g_sensitivity=cfg.calib_imu_g_sensitivity,
            imu_model=cfg.imu_model,
            slam_rep=cfg.feat_rep_slam,
            max_imu_batch=cfg.max_imu_batch,
            **self._layout_extras(),
        )
        L = self.layout
        s = init_state(L, dtype=self.dtype, device=self.device)
        # seed calibration values from config (IMU intrinsics: identity when None)
        seeds = dict(
            calib_cam_q=np.stack([c.q_ItoC for c in cfg.cameras]),
            calib_cam_p=np.stack([c.p_IinC for c in cfg.cameras]),
            calib_cam_intr=np.stack([c.intrinsics for c in cfg.cameras]),
            calib_dt=cfg.camimu_dt,
            calib_imu_dw=cfg.imu_dw, calib_imu_da=cfg.imu_da, calib_imu_tg=cfg.imu_tg,
            calib_imu_gq=cfg.imu_gq, calib_imu_aq=cfg.imu_aq,
        )
        s = s.replace(**{k: self._on(v) for k, v in seeds.items() if v is not None})
        # priors of the enabled calibration states (the reference puts
        # these in the initial covariance at construction)
        cov = s.cov
        if cfg.calib_imu_intrinsics:
            blk = np.diag(
                [cfg.calib_imu_dw_prior**2] * 6
                + [cfg.calib_imu_da_prior**2] * 6
                + ([cfg.calib_imu_tg_prior**2] * 9 if cfg.calib_imu_g_sensitivity else [])
                + [cfg.calib_imu_th_prior**2] * 3
            )
            cov = set_block_covariance(cov, L.imu_intr_off, blk)
        if cfg.calib_cam_timeoffset:
            cov = set_block_covariance(cov, L.calib_dt_off, np.array([[cfg.calib_dt_prior**2]]))
        if cfg.calib_cam_pose:
            blk = np.diag([cfg.calib_pose_prior_rot**2] * 3 + [cfg.calib_pose_prior_pos**2] * 3)
            for c in range(len(cfg.cameras)):
                cov = set_block_covariance(cov, L.calib_cam_pose_off + 6 * c, blk)
        if cfg.calib_cam_intrinsics:
            # focal/center at 1 px, distortion far tighter
            # (State.cpp:161-163: 1.0^2 vs 0.005^2)
            blk = np.diag([cfg.calib_intr_prior**2] * 4 + [cfg.calib_dist_prior**2] * 4)
            for c in range(len(cfg.cameras)):
                cov = set_block_covariance(cov, L.calib_cam_intr_off + 8 * c, blk)
        self.state: FilterState = s.replace(cov=cov)
        self.db = FeatureDatabase()
        self.is_initialized = False
        # imu buffer (host)
        self._imu_t: List[float] = []
        self._imu_w: List[np.ndarray] = []
        self._imu_a: List[np.ndarray] = []
        # host mirror: clone slot -> timestamp
        self.slot_times: Dict[int, float] = {}
        self._head = -1
        self.last_timing = None
        self._timing_file = None
        # the tracing switch, read once (`tracing.py`): spans on the
        # profiler's clock and the device ms of the graphs in the row
        self.tracing = tracing.enabled()
        self._span = tracing.span_for(self.tracing)
        # host clock at `feed_features`' entry, at the end of the fused
        # step's plan and at its read-back, for the frame's row
        self._t_start = self._t_planned = self._t_read = 0.0
        # traveled distance since initialization, accumulated per visual
        # update (`VioManager.cpp:646-650`); gates UWB ingestion
        # (UVioManager.cpp:64-67 `distance > min_dist_to_use_uwb`)
        self.distance = 0.0
        self._last_update_p: Optional[np.ndarray] = None
        # host mirrors of state.time / state.calib_dt: both are
        # deterministic on the host (time = the stamp of the last consumed
        # measurement; dt changes only via the EKF when timeoffset calib is
        # on, refreshed after sync updates). Reading either from the device
        # tensor would wait for the device on every frame, and
        # `plan_frame`'s UWB padding decision is defined on this host time.
        self._time_host: Optional[float] = None
        self._dt_host: float = float(cfg.camimu_dt)
        # camera-IMU time offset applied at the last propagation
        # (`Propagator::last_prop_time_offset`, Propagator.cpp:54-64):
        # IMU windows are [t_state + dt_last, t_meas + dt_now] so a
        # changing dt estimate never skips or double-counts IMU samples.
        self._last_prop_dt: Optional[float] = None
        self._startup_time = -np.inf  # SLAM delayed-init gate reference point
        self._last_frame_t: Optional[float] = None
        self._has_moved = False  # a ZUPT attempt was rejected
        self._async_since_check = 0  # async frames since a covariance check
        self.init_replay_rows: list = []
        # SLAM bookkeeping (host mirror of state.slam_id)
        self.slam_slot_by_fid: Dict[int, int] = {}
        self.slam_fail: Dict[int, int] = {}
        self.slam_consumed_t: Dict[int, float] = {}
        # the fused frame's counts for its timing row: the MSCKF features
        # with observations; the landmarks updated (had observations in the
        # plan), the delayed init's active candidates, initialized,
        # marginalized
        self._frame_counts = {"msckf_feats": 0, "slam_updated": 0, "slam_cands": 0, "slam_inited": 0,
                              "slam_marginalized": 0}

        # the stages, one graphed call each (`uvio_tpu`'s `_jit_*`): the
        # staged path runs them all; the init replay and the fused path's
        # landmark drop use some
        cam_model = cfg.cameras[0].model
        self._stage_prop = _stage(partial(propagate_and_clone, layout=L, noises=cfg.noises,
                                          gravity_mag=cfg.gravity_mag, integration=cfg.integration),
                                  "propagate_and_clone")
        self._stage_msckf = _stage(partial(msckf_update, layout=L, cam_model=cam_model,
                                           sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult), "msckf_update")
        self._stage_marg = _stage(partial(marginalize_clone, layout=L), "marginalize_clone")
        # IMU-rate pose output (`uvio_tpu`'s `_jit_fast_prop`): q, p, v
        # packed into one tensor for one read-back
        self._stage_fast_prop = _stage(
            lambda state, **imu: torch.cat(propagate_mean_only(
                state, **imu, gravity_mag=cfg.gravity_mag, imu_model=cfg.imu_model)),
            "propagate_mean_only")
        if cfg.max_slam > 0:
            self._stage_slam_up = _stage(partial(slam_update, layout=L, cam_model=cam_model,
                                                 sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult), "slam_update")
            self._stage_slam_init = _stage(partial(slam_delayed_init, layout=L, cam_model=cam_model,
                                                   sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult),
                                           "slam_delayed_init")
            self._stage_marg_slam = _stage(partial(marginalize_slam, layout=L), "marginalize_slam")
            self._stage_anchor_change = _stage(partial(anchor_change, layout=L), "anchor_change")
        if cfg.try_zupt:
            zupt = (partial(zupt_explicit_update, integration=cfg.integration)
                    if cfg.zupt_explicit else zupt_try_update)
            self._stage_zupt = _stage(partial(
                zupt, layout=L, noises=cfg.noises, gravity_mag=cfg.gravity_mag,
                chi2_mult=cfg.zupt_chi2_mult, noise_mult=cfg.zupt_noise_mult,
                max_velocity=cfg.zupt_max_velocity,
            ), "zupt")
        self.last_zupt_info = None
        if not cfg.fused_step:
            check_full_precision()
            return

        # the fused full-frame step: one call per camera frame
        self._full_cfg = FullStepConfig(
            layout=L,
            cam_model=cam_model,
            sigma_pix=cfg.sigma_pix,
            chi2_mult=cfg.chi2_mult,
            gravity_mag=cfg.gravity_mag,
            noises=cfg.noises,
            integration=cfg.integration,
            max_slam_init_per_frame=cfg.max_slam_init_per_frame,
            try_zupt=cfg.try_zupt,
            zupt_chi2_mult=cfg.zupt_chi2_mult,
            zupt_noise_mult=cfg.zupt_noise_mult,
            zupt_max_velocity=cfg.zupt_max_velocity,
            zupt_explicit=cfg.zupt_explicit,
            **self._full_step_extras(),
        )
        # the graphed step (`graphs.graphed`): `.eager` is the plain one
        self.full_step = make_packed_full_step(self._full_cfg)

        def full(state, fields):
            """One frame: `fields` is the numpy bundle keyed by
            `FrameBundle` field; the plan reads the host's state time."""
            with self._span("plan"):
                plan = plan_frame(fields, self._time_host)
            self._t_planned = _time.perf_counter()
            with self._span("pack"):
                return self.full_step(state, *pack_bundle(fields, self.device), plan)

        # the seam that `eval.capture` hooks to record the bundles
        self._jit_full = full

    # ------------------------------------------------------------------
    def _on(self, x, dtype=None) -> torch.Tensor:
        """`x` on the manager's device, in the compute dtype by default."""
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype, device=self.device)

    def _host(self, x, dtype=None) -> torch.Tensor:
        """`x` as a host tensor, in the compute dtype by default: a stage's
        input. On the card it is a fresh pinned tensor each call, so the
        stage's copy to the card neither waits nor races a later call."""
        t = torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _window(self, tt, ww, aa, stamp):
        """An IMU window and its camera-clock stamp as a stage's inputs:
        {imu_t, imu_w, imu_a, stamp_time}, host tensors (`_host`)."""
        f64 = torch.float64
        return dict(imu_t=self._host(tt, f64), imu_w=self._host(ww), imu_a=self._host(aa),
                    stamp_time=self._host(float(stamp), f64))

    def _async_eligible(self) -> bool:
        """Extra per-frame gate on the async (no-sync) dispatch path.
        Subclasses veto it while a host mirror that only updates on the
        sync path is still load-bearing (UVioManager: the traveled-
        distance UWB ingestion gate)."""
        return True

    def _check_cov_ok(self, cov_ok: bool, where: str):
        """Act on the device-side covariance health flag (negative
        diagonal / NaN after an update). Reference hard-exits
        (`StateHelper.cpp:102-113`); policy via cfg.on_cov_fail."""
        if cov_ok:
            return
        msg = (
            f"covariance diagonal negative/NaN after {where} at "
            f"t={float(self.state.time):.6f}"
        )
        if self.cfg.on_cov_fail == "raise":
            raise CovarianceError(msg)
        if self.cfg.on_cov_fail == "warn":
            warnings.warn(msg, RuntimeWarning)

    def _full_step_extras(self) -> dict:
        """FullStepConfig kwargs contributed by subclasses (UWB)."""
        return {}

    def _collect_uwb_sets(self, t_img: float):
        """Range-sets to drain inside the step (<= U, oldest first);
        overflow is handled by the subclass. Base: none."""
        return []

    def _consume_uwb_sets(self, sets):
        """Remove drained sets from the subclass buffer. Base: no-op."""

    # ------------------------------------------------------------------
    def initialize_with_gt(self, t, q_GtoI, p, v, bg, ba, prior_std=None):
        """Groundtruth initialization (`VioManagerHelper.cpp:40-76`)."""
        if prior_std is None:
            # the reference's exact gt-init prior
            # (`VioManagerHelper.cpp:49-53`: base 0.02, q 0.017, p 0.05,
            # v 0.01; biases stay at the 0.02 base)
            prior_std = np.concatenate(
                [
                    np.full(3, 0.017),  # theta (rad)
                    np.full(3, 0.05),  # p
                    np.full(3, 0.01),  # v
                    np.full(3, 0.02),  # bg
                    np.full(3, 0.02),  # ba
                ]
            )
        # set the IMU block prior; preserve any pre-seeded blocks
        # (anchor/extrinsic priors were installed at construction). One
        # download and one upload, once per run.
        cov = self.state.cov.cpu().numpy().copy()
        cov[:15, :] = 0.0
        cov[:, :15] = 0.0
        cov[:15, :15] = np.diag(np.asarray(prior_std) ** 2)
        q, p, v = self._on(q_GtoI), self._on(p), self._on(v)
        self.state = self.state.replace(
            time=self._on(float(t), torch.float64),
            q=q, q_fej=q, p=p, p_fej=p, v=v, v_fej=v,
            bg=self._on(bg), ba=self._on(ba), cov=self._on(cov),
        )
        self.is_initialized = True
        self._startup_time = float(t)
        self._time_host = float(t)

    # ------------------------------------------------------------------
    def _try_static_init(self):
        opts = self.cfg.init_options
        if self.cfg.try_zupt:
            # ZUPT can hold a still platform: init during stillness without
            # waiting for a jerk, gated on image disparity instead
            # (InertialInitializer.cpp:102-147 dual-condition dispatch)
            opts = dataclasses.replace(opts, wait_for_jerk=False)
            if not self._window_disparity_small(opts.window_time):
                return False
        res = try_static_init(
            np.asarray(self._imu_t),
            np.stack(self._imu_w) if self._imu_w else np.zeros((0, 3)),
            np.stack(self._imu_a) if self._imu_a else np.zeros((0, 3)),
            opts,
        )
        if res is None:
            return False
        self.initialize_with_gt(
            res.time, res.q_GtoI, res.p, res.v, res.bg, res.ba, prior_std=res.prior_std
        )
        # tracks older than the init stamp reference pre-init poses: drop
        self.db.cleanup_older_than(res.time + 1e-9)
        # the init stamp is the end of the STILL window, up to window/2 in
        # the past: fast-forward by propagate+clone through the already-
        # seen frame times like the reference's init thread
        # (`VioManagerHelper.cpp:151-160` clone_rate decimation), keeping
        # every IMU window short enough for the static batch limit
        frame_times = sorted(
            {tt for f in self.db.features.values() for tt in f.times() if tt > res.time}
        )
        # estimate rows for the replayed (already-seen) frames, from the
        # init stamp onward: recorders consume `init_replay_rows` for
        # latency-comparable output
        self.init_replay_rows = [(res.time, np.asarray(res.q_GtoI), np.asarray(res.p))]
        if frame_times:
            rate = len(frame_times) // self.cfg.max_clones + 1
            for ft in frame_times[::rate]:
                self._propagate_clone(ft, eager=True)
                self._marginalize(ft, eager=True)
                self.init_replay_rows.append((ft, *self.get_pose()))
        return True

    def _try_dynamic_init(self, t: float) -> bool:
        """In-motion initialization (the InertialInitializer's dynamic
        path): gather the last `num_pose` frame times, the feature tracks
        and the IMU slices between them, solve the shooting MLE on the
        manager's device (float64), gate on reprojection rmse, rcond and
        the biases, then seed the filter at the first pose and replay the
        window (`uvio_tpu/manager.py` `_try_dynamic_init`)."""
        opts = self.cfg.dyn_init_options or DynamicInitOptions()
        # rotation gate (init_dyn_min_deg): require accumulated gyro
        # rotation over the window before attempting (the reference sums
        # |w| dt in degrees, `DynamicInitializer.cpp:~110-130`)
        if opts.min_deg > 0 and self._imu_t:
            it = np.asarray(self._imu_t)
            iw = np.stack(self._imu_w)
            sel = it >= t - self.cfg.init_options.window_time
            if sel.sum() >= 2:
                dts = np.diff(it[sel])
                wn = np.linalg.norm(iw[sel][1:], axis=1)
                if np.degrees(np.sum(wn * np.clip(dts, 0, None))) < opts.min_deg:
                    return False
        # frame times observed so far (from the db)
        all_times = sorted({tt for f in self.db.features.values() for tt in f.times()})
        if len(all_times) < opts.num_pose:
            return False
        span = self.cfg.init_options.window_time
        pose_times = [tt for tt in all_times if tt >= t - span]
        if len(pose_times) < opts.num_pose:
            return False
        # demand most of the window to be filled: short spans let the
        # biases absorb arbitrary error while still fitting reprojection
        if pose_times[-1] - pose_times[0] < 0.75 * span:
            return False
        idx = np.linspace(0, len(pose_times) - 1, opts.num_pose).astype(int)
        pose_times = [pose_times[i] for i in sorted(set(idx))]
        if len(pose_times) < opts.num_pose:
            return False
        if not self._imu_t or self._imu_t[0] > pose_times[0]:
            return False
        P = opts.num_pose
        M = self.layout.max_imu_batch * 4
        imu_t = np.zeros((P - 1, M))
        imu_w = np.zeros((P - 1, M, 3))
        imu_a = np.zeros((P - 1, M, 3))
        # pose times are camera-clock: shift IMU windows by the seeded
        # camera-IMU offset (the initializer uses t_img + t_off as well)
        dt0 = self._dt_host
        times, ws, accs = np.asarray(self._imu_t), np.stack(self._imu_w), np.stack(self._imu_a)
        try:
            for i in range(P - 1):
                imu_t[i], imu_w[i], imu_a[i] = select_imu_readings_np(
                    times, ws, accs, pose_times[i] + dt0, pose_times[i + 1] + dt0, M
                )
        except ValueError:  # a backwards request or a window over M samples
            return False
        # feature tracks at those pose times (cam 0), undistorted
        cam = self.cfg.cameras[0]
        F = opts.max_features
        obs = np.zeros((F, P, 2))
        mask = np.zeros((F, P), bool)
        count = 0
        for f in self.db.features.values():
            by_t = {o[0]: (o[1], o[2]) for o in f.obs.get(0, [])}
            hits = [p for p, pt in enumerate(pose_times) if pt in by_t]
            if len(hits) < P - 1:
                continue
            for p in hits:
                obs[count, p] = by_t[pose_times[p]]
                mask[count, p] = True
            count += 1
            if count == F:
                break
        if count < opts.min_features:
            return False
        f64 = torch.float64
        on = lambda x, dtype=f64: torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)
        mask_d = on(mask, torch.bool)
        uvn = cam_models.undistort(on(cam.intrinsics), cam.model, on(obs.reshape(-1, 2))).reshape(F, P, 2)
        uvn = torch.where(mask_d[..., None], uvn, torch.zeros_like(uvn))
        out = solve_dynamic_init(
            on(imu_t), on(imu_w), on(imu_a), uvn, mask_d,
            quat_to_rot(on(cam.q_ItoC)), on(cam.p_IinC), opts,
        )
        if float(out["rmse_norm"]) > opts.max_reproj_rmse:
            return False
        # conditioning gate (init_dyn_min_rec_cond): accept only if the
        # IMU-state information block is well conditioned
        if float(out["rcond"]) < opts.min_rec_cond:
            return False
        # bias plausibility gates (an init that "explains" motion with a
        # huge accel bias is overfit, not initialized)
        p_sol = out["params"]
        if float(torch.linalg.vector_norm(p_sol["ba"])) > 0.5 or float(
            torch.linalg.vector_norm(p_sol["bg"])
        ) > 0.1:
            return False
        st = result_to_state_first(p_sol, opts)
        # seeded prior stds, scaled by the reference's inflation knobs
        # (init_dyn_inflation_*; base sigmas chosen so the reference
        # defaults 10/10/100/100 reproduce the tuned values below)
        s_ori = 0.10 * np.sqrt(opts.inflation_ori / 10.0)
        s_vel = 0.30 * np.sqrt(opts.inflation_vel / 10.0)
        s_bg = 0.05 * np.sqrt(opts.inflation_bg / 100.0)
        s_ba = 0.20 * np.sqrt(opts.inflation_ba / 100.0)
        prior_std = np.concatenate(
            [
                np.full(2, s_ori),  # roll/pitch (gravity estimate quality)
                np.full(1, 1e-4),  # yaw pinned (frame definition)
                np.full(3, 1e-4),  # position (origin definition)
                np.full(3, s_vel),  # velocity
                np.full(3, s_bg),
                np.full(3, s_ba),
            ]
        )
        self.initialize_with_gt(
            pose_times[0], st["q_GtoI"], st["p"], st["v"], st["bg"], st["ba"], prior_std=prior_std
        )
        # replay the window: clone at the first pose, then fast-forward
        # propagate+clone through the remaining pose times so the filter
        # starts with a full, well-conditioned clone window
        # (VioManagerHelper.cpp:111-166)
        self.state = augment_clone(self.state, self.layout, torch.zeros(3, dtype=self.dtype, device=self.device))
        K = self.layout.max_clones
        self._head = 0 if self._head < 0 else (self._head + 1) % K
        self.slot_times[self._head] = pose_times[0]
        # replay every frame time in the window (consecutive frames keep
        # IMU slices within max_imu_batch), marginalizing as we go.
        # No `init_replay_rows` here, as in `uvio_tpu`: the reference's
        # DYNAMIC init stamps at the window END (`DynamicInitializer.cpp`),
        # so its estimate file has no backdated rows (the static path
        # does backdate, matching the reference's static behaviour).
        for pt in [tt for tt in all_times if pose_times[0] < tt <= t]:
            self._propagate_clone(pt, eager=True)
            self._marginalize(pt, eager=True)
        # drop observations older than the window start; keep the rest
        self.db.cleanup_older_than(pose_times[0] - 1e-9)
        return True

    def _window_disparity_small(self, window: float) -> bool:
        """Mean feature displacement across the init window < threshold."""
        if not self._imu_t:
            return False
        t_new = self._imu_t[-1]
        t_old = t_new - window
        disps = []
        for f in self.db.features.values():
            for cam, lst in f.obs.items():
                if len(lst) < 2:
                    continue
                first = next((o for o in lst if o[0] >= t_old), None)
                last = lst[-1]
                if first is not None and last[0] > first[0]:
                    disps.append(np.hypot(last[1] - first[1], last[2] - first[2]))
        if not disps:
            return False
        return float(np.mean(disps)) < self.cfg.init_max_disparity

    def _disparity_small(self, t: float) -> bool:
        """Average track disparity between the two newest frames
        (FeatureHelper::compute_disparity semantics)."""
        prev = self._last_frame_t
        if prev is None:
            return False
        disps = []
        for f in self.db.features.values():
            for cam, lst in f.obs.items():
                uv_now = [o for o in lst if abs(o[0] - t) < 1e-9]
                uv_prev = [o for o in lst if abs(o[0] - prev) < 1e-9]
                if uv_now and uv_prev:
                    du = uv_now[0][1] - uv_prev[0][1]
                    dv = uv_now[0][2] - uv_prev[0][2]
                    disps.append(np.hypot(du, dv))
        if not disps:
            return False
        return float(np.mean(disps)) < self.cfg.zupt_max_disparity

    def feed_imu(self, t: float, w: np.ndarray, a: np.ndarray):
        self._imu_t.append(float(t))
        self._imu_w.append(np.asarray(w))
        self._imu_a.append(np.asarray(a))
        if not self.is_initialized:
            # bound the pre-init buffer to ~3 init windows
            horizon = 3.0 * self.cfg.init_options.window_time
            while self._imu_t and self._imu_t[0] < t - horizon:
                self._pop_imu()

    def _pop_imu(self):
        self._imu_t.pop(0)
        self._imu_w.pop(0)
        self._imu_a.pop(0)

    def _trim_imu(self, t: float):
        """Drop consumed IMU samples, keeping a tail for interpolation."""
        while len(self._imu_t) > 2 and self._imu_t[1] < t - 0.2:
            self._pop_imu()

    # ------------------------------------------------------------------
    def feed_features(self, t: float, cam_obs: List[Tuple[np.ndarray, np.ndarray]]):
        """Ingest one frame of tracked features and run the pipeline.

        cam_obs: per camera, (ids (N,), uvs (N,2)): the TrackSIM path
        (`feed_measurement_simulation`); a real frontend feeds the same.
        """
        self._t_start = _time.perf_counter()
        with self._span("frame"):
            with self._span("ingest"):
                if not self._ingest(t, cam_obs):
                    return
            if self.cfg.fused_step:
                self._frame_fused(t)
                # the row's last span runs from the read-back to here: the
                # bookkeeping, the frame's last mirrors, its locals released
                self.last_timing["post"] = _time.perf_counter() - self._t_read
                return
            if self.cfg.try_zupt and self._try_zupt(t):
                self._last_frame_t = t
                return  # motion frozen: no clone, no visual update this frame
            self._frame_staged(t)

    def _ingest(self, t: float, cam_obs) -> bool:
        """The frame's features into the database, then initialization
        and the out-of-order check: whether the frame goes on to a step."""
        for cam, (ids, uvs) in enumerate(cam_obs):
            for i, fid in enumerate(ids):
                self.db.update_feature(int(fid), t, cam, float(uvs[i, 0]), float(uvs[i, 1]))
        if not self.is_initialized:
            if self.cfg.use_static_init and self._try_static_init():
                return False
            if self.cfg.use_dynamic_init:
                self._try_dynamic_init(t)
            return False
        if t <= self._time_host:
            # out-of-order frame: warn + drop (`VioManager.cpp:329-334`)
            print_warning(
                "image at t=%.6f is older than state time %.6f: dropped", t, self._time_host
            )
            return False
        return True

    def _track_distance(self, p: np.ndarray):
        """Accumulate traveled distance after a completed visual update
        (`VioManager.cpp:646-650`) from the position `p` read this frame."""
        if self._last_update_p is not None:
            self.distance += float(np.linalg.norm(p - self._last_update_p))
        self._last_update_p = p

    def _fetch(self, infos):
        """Everything the host reads of one frame, in one transfer (the
        frame's only wait for the device): (zupt_accepted, cov_ok,
        slam_failed (S,), slam_inited (Fc,), p (3,), calib_dt)."""
        S = self.layout.max_slam
        Fc = infos["slam_inited"].shape[0]
        st = self.state
        parts = [infos["zupt_accepted"].reshape(1), infos["cov_ok"].reshape(1),
                 infos["slam_failed"], infos["slam_inited"], st.p, st.calib_dt.reshape(1)]
        host = torch.cat([x.to(torch.float64) for x in parts]).cpu().numpy()
        failed, inited = host[2 : 2 + S] != 0, host[2 + S : 2 + S + Fc] != 0
        return bool(host[0]), bool(host[1]), failed, inited, host[2 + S + Fc : 5 + S + Fc], float(host[-1])

    # ------------------------------------------------------------------
    def _frame_fused(self, t: float):
        """One frame: build the padded FrameBundle on the host, run
        `pipeline.full_filter_step`, then update the host mirrors from the
        returned infos (`do_feature_propagate_update` + UWB drain + ZUPT)."""
        t0h = _time.perf_counter()
        self._frame_counts = dict.fromkeys(self._frame_counts, 0)
        with self._span("build"):
            fields, frame = self._build_fields(t)
        t1h = self._t_planned = _time.perf_counter()

        # ---- the device step -------------------------------------------
        cfg = self.cfg
        fetched = None
        with self._span("step"):
            self.state, infos = self._jit_full(self.state, fields)
            t_enq = _time.perf_counter()
            # async mode: no host decision depends on this frame's device
            # results, so nothing is read back and the host goes on to build
            # the next bundle while the device works
            if not (cfg.async_dispatch and self.layout.max_slam == 0 and not cfg.try_zupt
                    and self._async_eligible()):
                with self._span("readback"):
                    fetched = self._fetch(infos)
        t2h = self._t_read = _time.perf_counter()

        with self._span("post"):
            post_s = self._post_fused(t, infos, frame, fetched, t2h)
        # async, nothing waited for the device: its ms are not read
        self._record_fused_timing(t, t1h - t0h, t2h - t1h, post_s, (self._t_start, t0h, t1h, t_enq, t2h),
                                  fetched is not None)

    def _build_fields(self, t: float):
        """The fused frame's host half: the padded FrameBundle's numpy
        fields, and what the bookkeeping after the step needs of the frame
        (`_post_fused`)."""
        L, cfg = self.layout, self.cfg
        K, S = L.max_clones, L.max_slam
        M = L.max_imu_batch
        U = self._full_cfg.uwb_sets_per_frame
        A = L.max_anchors

        dt_now = self._dt_host
        if self._last_prop_dt is None:
            self._last_prop_dt = dt_now
        # collect UWB sets BEFORE capturing the propagation cursor: on
        # overflow the staged drain propagates the state forward, and every
        # window below must start from the post-drain state time (otherwise
        # the drained IMU interval would be integrated twice)
        sets = self._collect_uwb_sets(t)
        cursor = self._time_host
        dt_last = self._last_prop_dt

        imu_t_arr = np.asarray(self._imu_t)
        imu_w_arr = np.stack(self._imu_w)
        imu_a_arr = np.stack(self._imu_a)

        def window(c0, d0, t1):
            return select_imu_readings_np(
                imu_t_arr, imu_w_arr, imu_a_arr, c0 + d0, max(t1 + dt_now, c0 + d0 + 1e-9), M
            )

        # ---- ZUPT host gates + window ---------------------------------
        zupt_try = False
        zt, zw, za = np.full(M, cursor), np.zeros((M, 3)), np.zeros((M, 3))
        if cfg.try_zupt:
            zupt_try = not (cfg.zupt_only_at_beginning and self._has_moved)
            if zupt_try and cfg.zupt_max_disparity > 0 and not self._disparity_small(t):
                zupt_try = False
            if zupt_try:
                zt, zw, za = window(cursor, dt_last, t)

        # ---- UWB range-set windows ------------------------------------
        u_t = np.full((U, M), cursor)
        u_w = np.zeros((U, M, 3))
        u_a = np.zeros((U, M, 3))
        u_stamp = np.full(U, cursor)
        u_r = np.zeros((U, A))
        u_m = np.zeros((U, A), bool)
        ucursor, udt_last = cursor, dt_last
        for k, (t_u, ranges) in enumerate(sets):
            if t_u > ucursor:
                u_t[k], u_w[k], u_a[k] = window(ucursor, udt_last, t_u)
                u_stamp[k] = t_u
                ucursor, udt_last = t_u, dt_now
            else:
                u_t[k] = np.full(M, ucursor)
                u_stamp[k] = ucursor
            for aid, dist in ranges.items():
                slot = self.anchor_slot_by_id[aid]
                u_r[k, slot] = dist
                u_m[k, slot] = True
        # padding rows keep the running cursor so masked-out sets never
        # rewind the device state timestamp mid-step
        u_stamp[len(sets):] = ucursor
        u_t[len(sets):] = ucursor

        # ---- main propagation window ----------------------------------
        tt, ww, aa = window(ucursor, udt_last, t)

        # ---- tentative ring advance (rolled back on ZUPT accept) ------
        new_head = 0 if self._head < 0 else (self._head + 1) % K
        saved_slots, saved_head = dict(self.slot_times), self._head
        self._head = new_head
        self.slot_times[new_head] = t

        marg_enable = len(self.slot_times) > cfg.max_clones
        marg_slot = min(self.slot_times, key=self.slot_times.get) if marg_enable else 0
        marg_t = self.slot_times.get(marg_slot) if marg_enable else None

        # ---- SLAM maintenance: drop dead-track landmarks (rare separate
        # dispatches, like the reference's should_marg flags)
        if S > 0:
            # Reference lifetime semantics (`VioManager.cpp:460-481`): a
            # landmark is marginalized when its feature is GONE FROM THE
            # DATABASE (its last observation has aged out of the clone
            # window), not the first frame its track misses, so a briefly
            # occluded feature resumes as the SAME landmark.
            horizon = min(self.slot_times.values()) if self.slot_times else t
            for fid in list(self.slam_slot_by_fid):
                f = self.db.features.get(fid)
                if f is None or f.newest_time() < horizon:
                    self._free_landmark(fid)
                    if f is not None:
                        f.to_delete = True
            self.db.cleanup()

        # ---- feature triage -> padded obs tensors ----------------------
        feats = self._select_msckf_feats(t)
        uv_m, mask_m = self._build_obs(feats, cfg.max_msckf_in_update)
        self._frame_counts["msckf_feats"] = int(mask_m.any(axis=(1, 2)).sum())

        uv_s, mask_s, slam_any_obs = self._slam_reobs()
        uv_c, mask_c, slots_c, fids_c = self._cand_rows(self._slam_candidates(t) if S > 0 else [])
        self._frame_counts["slam_updated"] = int(mask_s.any(axis=(1, 2)).sum())

        fields = dict(
            imu_t=tt, imu_w=ww, imu_a=aa,
            stamp_time=np.float64(t),
            msckf_uv=uv_m, msckf_mask=mask_m,
            slam_uv=uv_s, slam_mask=mask_s,
            cand_uv=uv_c, cand_mask=mask_c,
            cand_slots=slots_c, cand_ids=fids_c,
            uwb_imu_t=u_t, uwb_imu_w=u_w,
            uwb_imu_a=u_a, uwb_stamp=u_stamp,
            uwb_ranges=u_r, uwb_mask=u_m,
            zupt_try=np.bool_(zupt_try),
            zupt_imu_t=zt, zupt_imu_w=zw,
            zupt_imu_a=za,
            marg_enable=np.bool_(marg_enable),
            marg_slot=np.int32(marg_slot),
        )
        return fields, (sets, dt_now, feats, zupt_try, saved_slots, saved_head, marg_enable, marg_slot, marg_t,
                        slam_any_obs, slots_c, fids_c)

    def _post_fused(self, t: float, infos, frame, fetched, t2h: float) -> float:
        """The host mirrors after the fused step, from its infos and the
        frame's read-back `fetched` (None on the async path, which reads
        nothing back). Returns the seconds from the read-back (`t2h`) to
        the end of the bookkeeping, the row's `marginalization`: 0 when
        ZUPT froze the frame."""
        cfg, S = self.cfg, self.layout.max_slam
        (sets, dt_now, feats, zupt_try, saved_slots, saved_head, marg_enable, marg_slot, marg_t,
         slam_any_obs, slots_c, fids_c) = frame
        if fetched is None:
            self._async_since_check += 1
            if self._async_since_check >= _ASYNC_CHECK_EVERY:
                # check this frame's flag for all since the last check: cov
                # corruption persists (NaN stays NaN). The same transfer
                # refreshes the host mirrors that only the sync path
                # updates: the EKF moves calib_dt while the host builds IMU
                # windows from the mirror, and the traveled distance feeds
                # the UWB ingestion gate (UVioManager.cpp:64-67)
                self._async_since_check = 0
                _, cov_ok, _, _, p, calib_dt = self._fetch(infos)
                self._check_cov_ok(cov_ok, f"fused frame step (deferred, t={t:.3f})")
                if cfg.calib_cam_timeoffset:
                    self._dt_host = calib_dt
                self._track_distance(p)
            self.last_msckf_info = infos["msckf"]  # device tensors, lazy
            if sets:
                # the in-step UWB drain's bookkeeping is host-deterministic:
                # nothing below needs the device's accept flags
                self.last_uwb_info = {"accepted": infos["uwb_accepted"]}
                self._consume_uwb_sets(sets)
            self._last_prop_dt = dt_now
            self._consume_msckf(feats)
            if marg_enable:
                self.slot_times.pop(marg_slot, None)
                self.db.cleanup_older_than(marg_t + 1e-9)
            self._trim_imu(t)
            post_s = _time.perf_counter() - t2h
            self._last_frame_t = t
            self._time_host = float(t)
            return post_s

        z_acc, cov_ok, failed, inited, p, calib_dt = fetched

        if cfg.try_zupt and zupt_try and not z_acc:
            self._has_moved = True
        if z_acc:
            # motion frozen: no clone/update happened on device
            self.slot_times, self._head = saved_slots, saved_head
            self._time_host = float(t)
            self._last_prop_dt = dt_now
            self.db.cleanup_older_than(t + 1e-9)
            self._last_frame_t = t
            return 0.0

        self._check_cov_ok(cov_ok, "fused frame step")
        self.last_msckf_info = infos["msckf"]
        self.last_uwb_info = {"accepted": infos["uwb_accepted"]}
        self._consume_uwb_sets(sets)
        self._last_prop_dt = dt_now
        if cfg.calib_cam_timeoffset:
            # the EKF moved the dt estimate; refresh the host mirror
            self._dt_host = calib_dt

        self._consume_msckf(feats)

        # slam bookkeeping from infos
        if S > 0:
            if slam_any_obs:
                self._count_slam_failures(failed, t)
            self._adopt_inited(inited, fids_c, slots_c, t)

        # marginalization mirror (device already did anchor change + marg)
        if marg_enable:
            self.slot_times.pop(marg_slot, None)
            self.db.cleanup_older_than(marg_t + 1e-9)

        self._trim_imu(t)
        post_s = _time.perf_counter() - t2h
        self._last_frame_t = t
        self._time_host = float(t)
        self._track_distance(p)
        return post_s

    def _frame_staged(self, t: float):
        """One frame of the staged path (`uvio_tpu`'s non-fused branch of
        `feed_features`): each stage is its own call, and the host reads
        its decisions back before the next. The `last_timing` row times
        each stage on the host clock: its launch and its own read-backs,
        since nothing waits for the card between stages. Traced, a stage
        whose graphs replayed in the frame takes their device time instead
        (`device`, ms, read after the frame's last read-back)."""
        t0 = _time.perf_counter()
        self._pre_visual_update(t)
        t1 = _time.perf_counter()
        self._propagate_clone(t)
        t2 = _time.perf_counter()
        self._msckf_step(t)
        t3 = _time.perf_counter()
        if self.cfg.max_slam > 0:
            self._slam_step(t)
        t4 = _time.perf_counter()
        self._marginalize(t)
        t5 = _time.perf_counter()
        # the frame's last read-back: the position (traveled distance) and
        # the camera-IMU offset the EKF may have moved
        host = torch.cat([self.state.p, self.state.calib_dt.reshape(1)]).cpu().numpy()
        if self.cfg.calib_cam_timeoffset:
            self._dt_host = float(host[3])
        # per-stage times (the reference's timing CSV,
        # VioManager.cpp:604-644); seconds per stage
        row = {
            "timestamp": t,
            "uwb": t1 - t0,
            "propagation": t2 - t1,
            "msckf": t3 - t2,
            "slam": t4 - t3,
            "marginalization": t5 - t4,
            "total": t5 - t0,
        }
        if self.tracing:
            dev = self._staged_device_ms()
            if dev:
                row["device"] = dev
            for col, stage, _ in _STAGED:
                if stage in dev:
                    row[col] = dev[stage] / 1e3
        self._record_timing(row)
        self._last_frame_t = t
        self._time_host = float(t)
        self._track_distance(host[:3].astype(np.float64))

    def _try_zupt(self, t: float) -> bool:
        """The staged zero-velocity attempt (IMU + disparity test); True =
        motion frozen. `accepted` and the chi2 come back in one transfer."""
        cfg = self.cfg
        if cfg.zupt_only_at_beginning and self._has_moved:
            return False
        if cfg.zupt_max_disparity > 0 and not self._disparity_small(t):
            return False
        if t <= self._time_host:
            return False
        tt, ww, aa, dt_now = self._select_imu_window(t)
        new_state, accepted, gamma = self._stage_zupt(self.state, **self._window(tt, ww, aa, t))
        acc, gam = torch.stack([accepted.to(torch.float64), gamma.to(torch.float64)]).cpu().tolist()
        # observability: the reference prints the zupt chi2 each attempt
        # (`UpdaterZeroVelocity.cpp` PRINT_DEBUG)
        self.last_zupt_info = {"accepted": bool(acc), "gamma": gam, "n_imu": int((tt > tt[0]).sum()) + 1}
        if acc:
            self.state = new_state
            self._time_host = float(t)
            self._last_prop_dt = dt_now
            # consumed: observations at this frozen frame can't be used
            # later (no clone exists for t): drop them
            self.db.cleanup_older_than(t + 1e-9)
            return True
        self._has_moved = True
        return False

    def _msckf_step(self, t: float):
        """The staged MSCKF update over the triaged features; reads back
        `cov_ok` and consumes the features it used."""
        feats = self._select_msckf_feats(t)
        if not feats:
            return
        uv, mask = self._build_obs(feats, self.cfg.max_msckf_in_update)
        self.state, info = self._stage_msckf(self.state, obs_uv=self._host(uv),
                                             obs_mask=self._host(mask, torch.bool))
        self._check_cov_ok(bool(info["cov_ok"]), "msckf update")
        self.last_msckf_info = info
        self._consume_msckf(feats)

    def _slam_step(self, t: float):
        """Staged SLAM landmark maintenance: dead-track drop, re-observation
        update, failure accounting, delayed init of promoted max-track
        features (`uvio_tpu/manager.py` `_slam_step`)."""
        # 1) drop landmarks whose track died (reference marks should_marg)
        for fid in list(self.slam_slot_by_fid):
            f = self.db.features.get(fid)
            if f is None or f.newest_time() < t:
                self._free_landmark(fid)
                if f is not None:
                    f.to_delete = True
        self.db.cleanup()

        # 2) re-observation update with not-yet-consumed measurements;
        # cov_ok and the failure flags in one transfer
        uv, mask, any_obs = self._slam_reobs()
        if any_obs:
            self.state, info = self._stage_slam_up(self.state, obs_uv=self._host(uv),
                                                   obs_mask=self._host(mask, torch.bool))
            host = torch.cat([info["cov_ok"].reshape(1), info["failed"]]).cpu().numpy()
            self._check_cov_ok(bool(host[0]), "slam update")
            self._count_slam_failures(host[1:], t)

        # 3) delayed init of promoted candidates into free slots
        cands = self._slam_candidates(t)
        if cands:
            uv, mask, slots, fids = self._cand_rows(cands)
            self.state, info = self._stage_slam_init(
                self.state, obs_uv=self._host(uv), obs_mask=self._host(mask, torch.bool),
                target_slots=self._host(slots, torch.int64), cand_ids=self._host(fids, torch.int64),
            )
            self._adopt_inited(info["inited"].cpu().numpy(), fids, slots, t)

    def _slam_reobs(self):
        """(uv (S,K,C,2), mask (S,K,C), any): each landmark's observations
        at live clone times it has not consumed yet."""
        L = self.layout
        S, K, C = L.max_slam, L.max_clones, L.num_cams
        time_to_slot = {tt: s for s, tt in self.slot_times.items()}
        uv = np.zeros((S, K, C, 2))
        mask = np.zeros((S, K, C), bool)
        for fid, slot in self.slam_slot_by_fid.items():
            f = self.db.features.get(fid)
            cons = self.slam_consumed_t.get(fid, -np.inf)
            for cam, lst in f.obs.items():
                for (tt, u, v) in lst:
                    s = time_to_slot.get(tt)
                    if s is not None and tt > cons:
                        uv[slot, s, cam] = (u, v)
                        mask[slot, s, cam] = True
        return uv, mask, bool(mask.any())

    def _count_slam_failures(self, failed, t: float):
        """After a re-observation update: every landmark consumed its
        observations; a chi2 failure counts, and `slam_fail_marg` of them
        free the landmark (`failed` (S,) on the host)."""
        for fid in list(self.slam_slot_by_fid):
            slot = self.slam_slot_by_fid[fid]
            self.slam_consumed_t[fid] = t
            if failed[slot]:
                self.slam_fail[fid] = self.slam_fail.get(fid, 0) + 1
                if self.slam_fail[fid] >= self.cfg.slam_fail_marg:
                    f = self.db.features.get(fid)
                    if f is not None:
                        f.to_delete = True
                    self._free_landmark(fid)
        self.db.cleanup()

    def _cand_rows(self, cands):
        """The delayed-init rows of `cands` in free slots: (uv, mask,
        target slots, feature ids with -1 padding), Fc rows each."""
        Fc, S = self.cfg.max_slam_init_per_frame, self.layout.max_slam
        used = set(self.slam_slot_by_fid.values())
        free_slots = [s for s in range(S) if s not in used]
        cands = cands[: min(len(free_slots), Fc)]
        self._frame_counts["slam_cands"] = len(cands)
        slots = np.zeros(Fc, np.int32)
        fids = np.full(Fc, -1, np.int32)
        for i, f in enumerate(cands):
            slots[i] = free_slots[i]
            fids[i] = f.feat_id
        uv, mask = self._build_obs(cands, Fc)
        return uv, mask, slots, fids

    def _adopt_inited(self, inited, fids, slots, t: float):
        """Record the landmarks the delayed init accepted."""
        for i in range(len(fids)):
            if fids[i] >= 0 and inited[i]:
                self.slam_slot_by_fid[int(fids[i])] = int(slots[i])
                self.slam_consumed_t[int(fids[i])] = t
                self._frame_counts["slam_inited"] += 1

    def _consume_msckf(self, feats):
        """MSCKF features are used once (the reference sets to_delete)."""
        for f in feats:
            f.to_delete = True
        self.db.cleanup()

    def _record_fused_timing(self, t, build_s, device_s, post_s, stamps, waited: bool):
        """Per-frame timing, in seconds, under the staged CSV's columns:
        uwb <- host bundle build, propagation <- the device step (dispatch
        to the frame's one read-back; dispatch alone on the async path),
        msckf/slam <- 0 (inside the step; traced, the device time of the
        graph's MSCKF and SLAM stages), marginalization <- host
        bookkeeping. Beside them the frame's spans, host clock, s:
        `t_start` (the clock at `feed_features`' entry), `ingest` (the
        feature database and the checks before the frame), `build`,
        `step` = `plan` + `pack` (the bundle packed, the graph's inputs
        copied and the graph enqueued, to the graphed call's return) +
        `readback` (to the frame's read-back), `post` (from the read-back
        to `feed_features`' return, which sets it: `marginalization` and
        what follows it), so that they add up to the frame's time from
        `t_start` to its return; `capture_ms`, the warm-up + capture ms
        when the frame's plan was new, else 0; `msckf_feats`, the MSCKF
        features with observations in the bundle; the SLAM landmarks from the
        host's plan and bookkeeping, `slam_in_state` after the frame,
        `slam_updated` (with observations in the step), `slam_cands` (the
        delayed init's active candidates, `cand_ids >= 0`), `slam_inited`
        and `slam_marginalized` (dropped before or after it); and, traced
        and read back,
        `device`: ms of the replayed graph (`graph`) and of each stage it
        marks (`tracing.stage_ms`)."""
        t_start, t0h, t1h, t_enq, t2h = stamps
        row = {
            "timestamp": t,
            "uwb": build_s,
            "propagation": device_s,
            "msckf": 0.0,
            "slam": 0.0,
            "marginalization": post_s,
            "total": build_s + device_s + post_s,
            "t_start": t_start,
            "ingest": t0h - t_start,
            "build": build_s,
            "step": device_s,
            "plan": self._t_planned - t1h,
            "pack": t_enq - self._t_planned,
            "readback": t2h - t_enq,
            "capture_ms": getattr(self.full_step, "last_capture_ms", 0.0),
            "slam_in_state": len(self.slam_slot_by_fid),
            **self._frame_counts,
        }
        if self.tracing:
            timed = _take_timed(self.full_step)
            if waited and timed:
                row["device"] = dev = tracing.stage_ms(*timed[-1])
                row["msckf"] = dev.get("msckf", 0.0) / 1e3
                row["slam"] = dev.get("slam", 0.0) / 1e3
        self._record_timing(row)

    def _staged_device_ms(self) -> dict:
        """Device ms of each staged stage's graph replays since the last
        call (traced, once the stream has been waited for); a stage that
        replayed nothing is absent."""
        out = {}
        for _, stage, names in _STAGED:
            ms = [tracing.stage_ms(*r)["graph"] for n in names for r in _take_timed(getattr(self, n, None))]
            if ms:
                out[stage] = sum(ms)
        return out

    def _trace_on(self):
        """Tracing on for this manager and its graphed callables, as if the
        switch had been on when it was built (graphs captured before keep
        no device marks: their replays are timed whole)."""
        self.tracing = True
        self._span = tracing.span_for(True)
        for g in vars(self).values():
            if isinstance(g, Graphed):
                g.trace = True

    def _record_timing(self, row: dict):
        """Keep the frame's timing row and append it to the timing CSV."""
        self.last_timing = row
        if self._timing_file is not None:
            self._timing_file.write(
                f"{row['timestamp']:.9f},{row['uwb']:.6f},{row['propagation']:.6f},"
                f"{row['msckf']:.6f},{row['slam']:.6f},{row['marginalization']:.6f},"
                f"{row['total']:.6f}\n"
            )

    # ------------------------------------------------------------------
    def _pre_visual_update(self, t: float):
        """Hook for subclasses (UVIO drains buffered UWB ranges here)."""

    def _select_imu_window(self, t1_cam: float):
        """IMU slice for propagating the state (camera clock) to
        `t1_cam`: endpoints shifted into the IMU clock by the estimated
        camera-IMU offset, `time0 = t_state + dt_last`,
        `time1 = t_meas + dt_now` (`Propagator.cpp:54-64`). The state time
        is read from its host mirror. Returns (tt, ww, aa, dt_now); callers
        commit `self._last_prop_dt = dt_now` once the state time actually
        advances."""
        dt_now = self._dt_host
        if self._last_prop_dt is None:
            self._last_prop_dt = dt_now
        time0 = self._time_host + self._last_prop_dt
        # a dt estimate update can only shrink the window by ~ms; keep
        # it strictly positive for the slicer
        time1 = max(t1_cam + dt_now, time0 + 1e-9)
        tt, ww, aa = select_imu_readings_np(
            np.asarray(self._imu_t), np.stack(self._imu_w), np.stack(self._imu_a),
            time0, time1, self.layout.max_imu_batch,
        )
        return tt, ww, aa, dt_now

    def _propagate_clone(self, t: float, eager: bool = False):
        """Propagate and clone to camera time `t`; `eager` runs the stage
        without its graph (the init replay's one-off frames)."""
        tt, ww, aa, dt_now = self._select_imu_window(t)
        stage = self._stage_prop.eager if eager else self._stage_prop
        self.state = stage(self.state, **self._window(tt, ww, aa, t))
        self._time_host = float(t)
        self._last_prop_dt = dt_now
        # mirror ring arithmetic
        K = self.layout.max_clones
        self._head = 0 if self._head < 0 else (self._head + 1) % K
        self.slot_times[self._head] = t
        self._trim_imu(t)

    # ------------------------------------------------------------------
    def _select_msckf_feats(self, t: float):
        """Triage (`VioManager.cpp:366-500`): lost features + features
        observed at the to-be-marginalized clone time, longest tracks
        first, capped."""
        lost = [f for f in self.db.features_not_seen_at(t) if f.num_obs() >= 2]
        marg = []
        if len(self.slot_times) > self.cfg.max_clones:
            marg_t = min(self.slot_times.values())
            marg = [f for f in self.db.features_seen_at(marg_t) if f.newest_time() >= t]
        feats = {f.feat_id: f for f in lost + marg}
        # SLAM-tracked features never go through the MSCKF path
        for fid in self.slam_slot_by_fid:
            feats.pop(fid, None)
        # max-track candidates are promoted to SLAM instead (when slots free)
        for f in self._slam_candidates(t):
            feats.pop(f.feat_id, None)
        out = sorted(feats.values(), key=lambda f: -f.num_obs())
        return out[: self.cfg.max_msckf_in_update]

    def _slam_candidates(self, t: float):
        """Max-track features eligible for SLAM promotion: observed at the
        to-be-marginalized clone, still tracked, spanning the window."""
        if self.cfg.max_slam == 0 or len(self.slot_times) <= self.cfg.max_clones:
            return []
        # wait dt_slam_delay after startup before the first delayed init
        # (VioManager.cpp:443-444 "prevents bad first set of slam points")
        if t - self._startup_time < self.cfg.dt_slam_delay:
            return []
        free = self.cfg.max_slam - len(self.slam_slot_by_fid)
        if free <= 0:
            return []
        marg_t = min(self.slot_times.values())
        window_times = set(self.slot_times.values())
        out = []
        for f in self.db.features_seen_at(marg_t):
            if f.feat_id in self.slam_slot_by_fid:
                continue
            if f.newest_time() < t:
                continue
            if len(f.times() & window_times) >= self.cfg.max_clones:
                out.append(f)
        # Deliberate deviation, kept from uvio_tpu: among tied full-window
        # tracks, promote the OLDEST (stable sort over insertion order).
        # The reference takes the NEWEST instead (`VioManager.cpp:446-451`
        # slices the END of the insertion-ordered maxtracks vector); older
        # tracks have survived longer and carry more verified geometry.
        out = sorted(out, key=lambda f: -f.num_obs())
        return out[: min(free, self.cfg.max_slam_init_per_frame)]

    def _build_obs(self, feats, n_rows: int):
        """Pad tracks into (n_rows,K,C,2)+(n_rows,K,C) aligned to clone slots."""
        K, C = self.layout.max_clones, self.layout.num_cams
        uv = np.zeros((n_rows, K, C, 2))
        mask = np.zeros((n_rows, K, C), bool)
        time_to_slot = {tt: s for s, tt in self.slot_times.items()}
        for i, f in enumerate(feats):
            for cam, lst in f.obs.items():
                for (tt, u, v) in lst:
                    s = time_to_slot.get(tt)
                    if s is not None:
                        uv[i, s, cam] = (u, v)
                        mask[i, s, cam] = True
        return uv, mask

    # ------------------------------------------------------------------
    def _free_landmark(self, fid: int):
        slot = self.slam_slot_by_fid.pop(fid)
        self.slam_fail.pop(fid, None)
        self.slam_consumed_t.pop(fid, None)
        self._frame_counts["slam_marginalized"] += 1
        # (the slot as a host tensor, as `uvio_tpu`'s `jnp.int32(slot)`: a
        # Python int would key a graph per slot value)
        self.state = self._stage_marg_slam(self.state, slot=self._host(slot, torch.int64))

    def _marginalize(self, t: float, eager: bool = False):
        """Marginalize the oldest clone once the ring holds one more than
        `max_clones`; `eager` as in `_propagate_clone`."""
        if len(self.slot_times) > self.cfg.max_clones:
            slot = min(self.slot_times, key=self.slot_times.get)
            marg_t = self.slot_times.pop(slot)
            slot_h = self._host(slot, torch.int64)
            # re-anchor landmarks whose anchor clone is about to die
            # (UpdaterSLAM::change_anchors)
            if self.cfg.max_slam > 0 and self.cfg.feat_rep_slam != 0:
                stage = self._stage_anchor_change.eager if eager else self._stage_anchor_change
                self.state = stage(self.state, marg_slot=slot_h, new_slot=self.state.clone_head)
            stage = self._stage_marg.eager if eager else self._stage_marg
            self.state = stage(self.state, slot=slot_h)
            # drop observations at (and before) the marginalized time:
            # their clone no longer exists
            self.db.cleanup_older_than(marg_t + 1e-9)

    # ------------------------------------------------------------------
    def get_propagated_pose(self, t: float):
        """IMU-rate pose output: mean-only propagation of the current
        state to time t (`fast_state_propagate` /
        `visualize_odometry` equivalent). Returns (q_GtoI, p, v)."""
        t0 = self._time_host if self._time_host is not None else -np.inf
        st = self.state
        if not self.is_initialized or t <= t0 or not self._imu_t:
            qpv = torch.cat([st.q, st.p, st.v]).cpu().numpy()
        else:
            # same offset-shifted window as the filter
            # (`fast_state_propagate` uses time0/time1 with t_off too,
            # Propagator.cpp:148-154); the transient prediction does not
            # commit _last_prop_dt. One graph replay, one read-back.
            tt, ww, aa, _ = self._select_imu_window(t)
            win = self._window(tt, ww, aa, t)
            qpv = self._stage_fast_prop(st, imu_t=win["imu_t"], imu_w=win["imu_w"], imu_a=win["imu_a"]).cpu().numpy()
        return qpv[:4], qpv[4:7], qpv[7:10]

    def record_timing(self, path: str):
        """Start recording per-stage timing rows to a CSV
        (record_timing_information / record_timing_filepath). It turns
        tracing on for the process and for this manager (`tracing.py`), so
        the rows take the stages' device times (`_record_timing`)."""
        tracing.enable()
        self._trace_on()
        self._timing_file = open(path, "w")
        self._timing_file.write("# timestamp,uwb,propagation,msckf,slam,marginalization,total\n")

    def get_pose(self):
        """Current (q_GtoI, p_IinG) estimate as numpy."""
        return self.state.q.cpu().numpy(), self.state.p.cpu().numpy()

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str):
        """Snapshot the full estimator (state + host mirror) to one .npz,
        in `uvio_tpu`'s layout, so a restart resumes exactly where it left
        off, in either package."""
        n = self.cfg.max_imu_batch
        meta = {
            "is_initialized": bool(self.is_initialized),
            "head": int(self._head),
            "slot_times": {str(k): float(v) for k, v in self.slot_times.items()},
            "last_frame_t": float(self._last_frame_t or 0.0),
            "last_prop_dt": (
                float(self._last_prop_dt) if self._last_prop_dt is not None else None
            ),
            # keep at least one full propagation window of IMU history so
            # the first post-restore propagation sees every reading it needs
            "imu_t": [float(t) for t in self._imu_t[-n:]],
            "imu_w": [list(map(float, w)) for w in self._imu_w[-n:]],
            "imu_a": [list(map(float, a)) for a in self._imu_a[-n:]],
            "db": self.db.to_dict(),
            "slam_slot_by_fid": {str(k): v for k, v in self.slam_slot_by_fid.items()},
            "slam_fail": {str(k): v for k, v in self.slam_fail.items()},
            "slam_consumed_t": {str(k): v for k, v in self.slam_consumed_t.items()},
        }
        save_state(path, self.state, meta)

    def load_checkpoint(self, path: str):
        """Restore a `save_checkpoint` snapshot into this manager (must
        be constructed with the same config/layout)."""
        state, meta = load_state(path, self.state)
        self.state = state
        # host mirrors rebuilt from the restored state (a one-time read)
        self._time_host = float(state.time)
        self._dt_host = float(state.calib_dt)
        self.is_initialized = meta["is_initialized"]
        self._head = meta["head"]
        self.slot_times = {int(k): v for k, v in meta["slot_times"].items()}
        self._last_frame_t = meta["last_frame_t"]
        self._last_prop_dt = meta.get("last_prop_dt")
        self._imu_t = list(meta["imu_t"])
        self._imu_w = [np.asarray(w) for w in meta["imu_w"]]
        self._imu_a = [np.asarray(a) for a in meta["imu_a"]]
        self.db = FeatureDatabase.from_dict(meta.get("db", {}))
        self.slam_slot_by_fid = {int(k): int(v) for k, v in meta.get("slam_slot_by_fid", {}).items()}
        self.slam_fail = {int(k): int(v) for k, v in meta.get("slam_fail", {}).items()}
        self.slam_consumed_t = {int(k): float(v) for k, v in meta.get("slam_consumed_t", {}).items()}

    # ------------------------------------------------------------------
    def get_active_tracks(self, t: Optional[float] = None):
        """3D positions of features tracked into the newest frame: the
        reference's `retriangulate_active_tracks`
        (`VioManagerHelper.cpp:190-387`), which feeds visualization and
        loop-closure consumers.

        Returns (ids (N,), p_FinG (N,3)) of successfully triangulated
        active MSCKF tracks, plus all valid SLAM landmarks (their slot
        ids are the feature ids they were promoted from).
        """
        t = self._last_frame_t if t is None else t
        feats = [f for f in self.db.features_seen_at(t) if f.feat_id not in self.slam_slot_by_fid]
        ids_out, pts_out = [], []
        if feats:
            L = self.layout
            K, C = L.max_clones, L.num_cams
            st = self.state
            uv, mask = self._build_obs(feats, len(feats))
            uv_d = self._on(uv)
            uvn = torch.stack(
                [
                    cam_models.undistort(st.calib_cam_intr[c], self.cfg.cameras[c].model, uv_d[:, :, c, :])
                    for c in range(C)
                ],
                dim=2,
            )
            (R_val, p_val), _ = clone_camera_poses(st, L)
            p_f, ok = triangulate_batch(
                uvn.reshape(len(feats), K * C, 2),
                self._on(mask, torch.bool).reshape(len(feats), K * C),
                R_val.reshape(K * C, 3, 3),
                p_val.reshape(K * C, 3),
            )
            ok, p_f = ok.cpu().numpy(), p_f.cpu().numpy()
            for i, f in enumerate(feats):
                if ok[i]:
                    ids_out.append(f.feat_id)
                    pts_out.append(p_f[i])
        # SLAM landmarks: exact representation-chained global positions
        if self.cfg.max_slam > 0:
            p_glob = landmark_global(self.state, self.layout)[0].cpu().numpy()
            valid = self.state.slam_valid.cpu().numpy()
            sid = self.state.slam_id.cpu().numpy()
            for s in range(self.cfg.max_slam):
                if valid[s]:
                    ids_out.append(int(sid[s]))
                    pts_out.append(p_glob[s])
        if not ids_out:
            return np.zeros(0, np.int64), np.zeros((0, 3))
        return np.asarray(ids_out), np.stack(pts_out)

"""The per-frame filter steps: `filter_step` (MSCKF only) and
`full_filter_step`, the whole device-side frame of the UWB + SLAM system.

Port of `uvio_tpu/pipeline.py`. `full_filter_step` runs the reference's
per-frame hot path (`UVioManager::track_image_and_update` +
`do_feature_propagate_update`, UVioManager.cpp:114-205,
VioManager.cpp:323-714) on one padded `FrameBundle`:

    [ZUPT attempt] -> [UWB drain: propagate (no clone) + range updates,
    per range set] -> propagate+clone -> MSCKF -> SLAM re-observation
    update -> SLAM delayed init -> [anchor change + clone marginalization]

Nothing inside a step synchronises with the host, and every loop has a
static trip count. Each `lax.cond` of `uvio_tpu` became either a host
decision, read from a `FramePlan` of Python bools that `plan_frame`
builds from the numpy bundle before upload, or a `torch.where` select
over both computed branches where the predicate lives on the device:

| site (`uvio_tpu/...`) | predicate depends on | here |
|---|---|---|
| `pipeline.py:60-62` (`filter_step` marg) | state: `all(clones_valid)` | select |
| `pipeline.py:212-214` (ZUPT attempt) | bundle: `zupt_try` | host decision (`plan.zupt_try`) |
| `pipeline.py:345` (ZUPT accepted -> skip visual) | device: `z_acc` | select; statically absent when `try_zupt` is False or the plan skips the attempt |
| `pipeline.py:262-267` (UWB padding row) | mask and stamp against `s.time` | host decision (`plan.uwb_rows`): after every step the state time is the bundle's `stamp_time`, so the host replays `any(mask) or stamp > time` row by row |
| `pipeline.py:314-316` (delayed-init gate) | bundle: `any(cand_ids >= 0)` | host decision (`plan.slam_init`) |
| `pipeline.py:333` (anchor change + marg) | bundle: `marg_enable` | host decision (`plan.marg`) |
| `slam.py:319` (per-candidate init) | device: chi2, `Hf_tri` | select |
| `uwb.py:132` (per-range accept) | device: chi2 | select |
| `zupt.py:177`, `:275-280` | device: gate, `has_clone` | select |
| `representations.py:358` (per-slot re-anchor) | device: `slam_anchor_slot == marg_slot` | select inside one batched `T P T^T` |

Index ranges: torch gathers do not clamp as `lax.dynamic_slice` does, so
every traced index must be a valid slot. The bundle's `marg_slot` and
`cand_slots` are valid by construction (host slot bookkeeping);
`clone_head` is valid after propagate+clone, where SLAM init and the
anchor change read it; the explicit ZUPT clamps `clone_head = -1` to 0
(`zupt.py:231`).

`make_batched_step` is `filter_step` under `torch.func.vmap` over a
leading sequence-batch axis (`uvio_tpu`'s `jax.vmap`); `uvio_tpu`'s
optional sharding of that axis over a device mesh ("dp") is not ported.
`HostPipeline` stages chunk k+1 on the device from a thread while the
caller runs chunk k.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import resolve_device
from .filter.ekf import marginalize_clone
from .filter.propagator import INTEGRATIONS, NoiseManager, propagate_and_clone, propagate_mean_cov
from .frontend.fused_vio import check_full_precision
from .types.layout import StateLayout
from .types.state import FIELDS, FilterState, oldest_clone_slot, where_state
from .update.msckf import msckf_update
from .update.representations import anchor_change
from .update.slam import slam_delayed_init, slam_update
from .update.uwb import uwb_update
from .update.zupt import zupt_explicit_update, zupt_try_update


@dataclasses.dataclass(frozen=True)
class StepConfig:
    layout: StateLayout
    cam_model: int = 0
    sigma_pix: float = 1.0
    chi2_mult: float = 1.0
    gravity_mag: float = 9.81
    noises: NoiseManager = dataclasses.field(default_factory=NoiseManager)


def filter_step(state, imu_t, imu_w, imu_a, obs_uv, obs_mask, *, cfg: StepConfig):
    """One camera-frame step: [marginalize the oldest clone if the ring is
    full] -> propagate+clone -> MSCKF. imu_* padded (M,)/(M,3); obs
    (F,K,C,2)."""
    L = cfg.layout
    marg = marginalize_clone(state, L, oldest_clone_slot(state, L))
    state = where_state(state.clones_valid.all(), marg, state)
    state = propagate_and_clone(state, L, imu_t, imu_w, imu_a, cfg.noises, cfg.gravity_mag)
    return msckf_update(
        state, L, cfg.cam_model, obs_uv, obs_mask, sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult
    )


def make_step(cfg: StepConfig):
    """The single-sequence step, `step(state, imu_t, imu_w, imu_a, obs_uv,
    obs_mask)`."""
    check_full_precision()
    return lambda *args: filter_step(*args, cfg=cfg)


def make_batched_step(cfg: StepConfig):
    """`filter_step` over a leading sequence-batch axis (multi-sequence
    Monte-Carlo / dataset evaluation): `step(state, imu_t, imu_w, imu_a,
    obs_uv, obs_mask)` with a leading axis B on every state field and
    input, returning the batched state and infos.

    `torch.func.vmap` rather than a written-out batch dimension: the step
    is the single-sequence code, so the batched step cannot drift from
    it. Its in-place block writes stay batched under vmap because every
    buffer they write into is allocated from a batched tensor
    (`new_zeros`), and the step makes no data-dependent host decision.
    """
    check_full_precision()

    def one(fields, *args):
        st, info = filter_step(FilterState(**dict(zip(FIELDS, fields))), *args, cfg=cfg)
        return tuple(getattr(st, n) for n in FIELDS), info

    batched = torch.func.vmap(one)

    def step(state, *args):
        fields, info = batched(tuple(getattr(state, n) for n in FIELDS), *args)
        return FilterState(**dict(zip(FIELDS, fields))), info

    return step


class HostPipeline:
    """Double-buffered host->device chunk staging.

    The reference overlaps sensor ingestion with estimation with a detached
    camera-processing thread (`UVIOROS1Visualizer.cpp:72-114`). Here a
    background thread stages chunk k+1's arrays on the device while the
    caller runs chunk k, at most `depth` chunks ahead.

    On a CUDA device each leaf goes through pinned host memory and a
    `non_blocking` copy on a side stream; the consumer's stream waits on
    the copy's event before the chunk is handed out, and each staged
    tensor is recorded on the consumer's stream so its memory outlives
    the copy. On the CPU the leaves are plain copies. A chunk is any
    nesting of dicts, lists, tuples and named tuples whose leaves are
    numpy arrays, tensors or numbers; `device=None` is `default_device()`.

    Usage:
        pipe = HostPipeline(chunk_source)   # iterator of chunks
        for staged in pipe:                 # staged already on device
            state, out = run_chunk(state, staged)
    """

    def __init__(self, chunks, device=None, depth: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._device = resolve_device(device)
        self._sentinel = object()
        cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None

        def worker():
            try:
                for c in chunks:
                    self._q.put(self._stage(c))
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _stage(self, chunk):
        """(staged chunk, copy event or None)."""
        from torch.utils._pytree import tree_map

        def host(x):
            return x.detach().cpu() if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))

        if self._stream is None:
            return tree_map(lambda x: host(x).to(self._device, copy=True), chunk), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            staged = tree_map(lambda x: host(x).pin_memory().to(self._device, non_blocking=True), chunk)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def __iter__(self):
        from torch.utils._pytree import tree_leaves

        while True:
            item = self._q.get()
            if item is self._sentinel:
                return
            staged, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(event)
                for x in tree_leaves(staged):
                    x.record_stream(consumer)
            yield staged


class FrameBundle(NamedTuple):
    """Per-frame padded inputs of `full_filter_step`. Leading dims are
    static: M IMU samples, F MSCKF features, S slam slots, Fc init
    candidates, U UWB range sets (each with its own M-sample window)."""

    # propagation to the image time (camera-clock stamp)
    imu_t: torch.Tensor  # (M,) f64
    imu_w: torch.Tensor  # (M,3)
    imu_a: torch.Tensor  # (M,3)
    stamp_time: torch.Tensor  # () f64
    # MSCKF features (aligned to clone slots incl. the one being added)
    msckf_uv: torch.Tensor  # (F,K,C,2)
    msckf_mask: torch.Tensor  # (F,K,C)
    # SLAM re-observations (indexed by slam slot)
    slam_uv: torch.Tensor  # (S,K,C,2)
    slam_mask: torch.Tensor  # (S,K,C)
    # SLAM delayed-init candidates
    cand_uv: torch.Tensor  # (Fc,K,C,2)
    cand_mask: torch.Tensor  # (Fc,K,C)
    cand_slots: torch.Tensor  # (Fc,) target slam slots
    cand_ids: torch.Tensor  # (Fc,) feature ids, -1 = inactive
    # UWB range sets drained before the visual update
    uwb_imu_t: torch.Tensor  # (U,M) f64
    uwb_imu_w: torch.Tensor  # (U,M,3)
    uwb_imu_a: torch.Tensor  # (U,M,3)
    uwb_stamp: torch.Tensor  # (U,) f64
    uwb_ranges: torch.Tensor  # (U,A)
    uwb_mask: torch.Tensor  # (U,A)
    # ZUPT attempt window
    zupt_try: torch.Tensor  # () bool
    zupt_imu_t: torch.Tensor  # (M,) f64
    zupt_imu_w: torch.Tensor  # (M,3)
    zupt_imu_a: torch.Tensor  # (M,3)
    # end-of-frame clone marginalization (host-chosen slot)
    marg_enable: torch.Tensor  # () bool
    marg_slot: torch.Tensor  # ()


_TIME_FIELDS = ("imu_t", "stamp_time", "uwb_imu_t", "uwb_stamp", "zupt_imu_t")
_BOOL_FIELDS = ("msckf_mask", "slam_mask", "cand_mask", "uwb_mask", "zupt_try", "marg_enable")
_INT_FIELDS = ("cand_slots", "cand_ids", "marg_slot")


def bundle_from_numpy(fields, device=None, dtype=torch.float64) -> FrameBundle:
    """A `FrameBundle` on `device` (None: `default_device()`, the card or
    an error) from numpy arrays keyed by field name
    (a mapping, or a bundle of numpy leaves such as `uvio_tpu`'s). Times
    stay float64, masks bool, indices int64; the rest takes `dtype`.

    The leaves cross to the device together: packed into one float64
    buffer (which holds every mask and index exactly), and on a CUDA device
    copied from pinned memory without waiting for the device, so a caller
    that reads nothing back keeps running ahead of it.
    """
    device = resolve_device(device)
    get = fields.__getitem__ if isinstance(fields, dict) else lambda n: getattr(fields, n)
    leaves = [np.asarray(get(n)) for n in FrameBundle._fields]
    flat = torch.from_numpy(np.concatenate([a.ravel().astype(np.float64) for a in leaves]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)

    def conv(name, x):
        if name in _TIME_FIELDS:
            return x
        if name in _BOOL_FIELDS:
            return x != 0
        return x.to(torch.int64 if name in _INT_FIELDS else dtype)

    sizes = [a.size for a in leaves]
    parts = torch.split(flat, sizes)
    return FrameBundle(*(conv(n, x.reshape(a.shape)) for n, x, a in zip(FrameBundle._fields, parts, leaves)))


class FramePlan(NamedTuple):
    """The decisions of one step that the bundle alone settles, as Python
    bools (see the module table)."""

    zupt_try: bool
    uwb_rows: Tuple[bool, ...]  # which range sets propagate + update
    slam_init: bool  # any active init candidate
    marg: bool  # anchor change + clone marginalization


def plan_frame(fields, state_time: float) -> FramePlan:
    """The plan of one bundle, from its numpy fields (a mapping or a
    bundle of numpy leaves) and the state time before the step.

    A UWB row runs iff it has a range or its stamp is past the state time
    (`uvio_tpu`'s `any(mask) | (stamp > s.time)`), and a row that runs
    moves the state time to its stamp. After the step the state time is
    the bundle's `stamp_time`: pass that as the next bundle's
    `state_time`.
    """
    get = fields.__getitem__ if isinstance(fields, dict) else lambda n: getattr(fields, n)
    t = float(state_time)
    rows = []
    for ts, rm in zip(np.asarray(get("uwb_stamp"), np.float64), np.asarray(get("uwb_mask"))):
        run = bool(np.any(rm)) or float(ts) > t
        rows.append(run)
        if run:
            t = float(ts)
    return FramePlan(
        zupt_try=bool(get("zupt_try")),
        uwb_rows=tuple(rows),
        slam_init=bool(np.any(np.asarray(get("cand_ids")) >= 0)),
        marg=bool(get("marg_enable")),
    )


@dataclasses.dataclass(frozen=True)
class FullStepConfig:
    layout: StateLayout
    cam_model: int = 0
    sigma_pix: float = 1.0
    chi2_mult: float = 1.0
    gravity_mag: float = 9.81
    noises: NoiseManager = dataclasses.field(default_factory=NoiseManager)
    integration: str = "rk4"
    # SLAM
    max_slam_init_per_frame: int = 8
    # UWB (active when uwb_sets_per_frame > 0 and layout.max_anchors > 0)
    uwb_sets_per_frame: int = 0
    sigma_range: float = 0.1
    uwb_chi2_mult: float = 1.0
    # ZUPT (compiled in only when try_zupt)
    try_zupt: bool = False
    zupt_chi2_mult: float = 1.0
    zupt_noise_mult: float = 10.0
    zupt_max_velocity: float = 0.1
    # explicit zero-motion clone-pair constraint instead of the direct
    # inertial update (`UpdaterZeroVelocity.cpp:283-330`)
    zupt_explicit: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "FullStepConfig":
        """From `dataclasses.asdict` of a `uvio_tpu` FullStepConfig."""
        d = dict(d)
        d["layout"] = StateLayout(**d["layout"])
        d["noises"] = NoiseManager(**d["noises"])
        return cls(**d)


def _skipped(infos):
    """The infos of a frame whose visual part did not run: every flag and
    count zero, every `cov_ok` true (`uvio_tpu`'s `_dummy_infos`)."""
    return {
        k: _skipped(v) if isinstance(v, dict) else
        torch.ones_like(v) if k == "cov_ok" else torch.zeros_like(v)
        for k, v in infos.items()
    }


def _select_infos(pred, a, b):
    return {
        k: _select_infos(pred, a[k], v) if isinstance(v, dict) else torch.where(pred, a[k], v)
        for k, v in b.items()
    }


def _uwb_drain(st, fb, plan, cfg):
    """Per UWB range set the plan runs: propagate (no clone) to its stamp,
    then the sequential range updates. Returns (state, accepted (U,A),
    chi2 (U,A); zeros on rows the plan skips)."""
    L = cfg.layout
    U = fb.uwb_ranges.shape[0] if cfg.uwb_sets_per_frame > 0 else 0
    A = L.max_anchors
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=st.cov.device)
    no_chi2 = torch.zeros((A,), dtype=st.cov.dtype, device=st.cov.device)
    if U == 0 or A == 0:
        return st, zeros(U, A), no_chi2.expand(U, A)
    rows, chi2 = [], []
    for k in range(U):
        if not plan.uwb_rows[k]:
            rows.append(zeros(A))
            chi2.append(no_chi2)
            continue
        st, _ = propagate_mean_cov(
            st, L, fb.uwb_imu_t[k], fb.uwb_imu_w[k], fb.uwb_imu_a[k], cfg.noises,
            cfg.gravity_mag, integration=cfg.integration, stamp_time=fb.uwb_stamp[k],
        )
        st, info = uwb_update(
            st, L, fb.uwb_ranges[k], fb.uwb_mask[k],
            sigma_range=cfg.sigma_range, chi2_mult=cfg.uwb_chi2_mult,
        )
        # Deliberate deviation from the reference, kept from uvio_tpu
        # (`pipeline.py:242-254`): re-seed the IMU-state FEJ to the
        # range-updated mean, so the next propagation's first interval
        # linearizes at the corrected state (uwb head-to-head stream:
        # 0.015 m ATE with the refresh, 0.018 m with the reference's FEJ
        # semantics). Clone and landmark FEJ are untouched.
        st = st.replace(q_fej=st.q, p_fej=st.p, v_fej=st.v)
        rows.append(info["accepted"])
        chi2.append(info["chi2"])
    return st, torch.stack(rows), torch.stack(chi2)


def _visual(state, fb, plan, cfg):
    """UWB drain -> propagate+clone -> MSCKF -> SLAM -> marginalization."""
    L = cfg.layout
    S, Fc = L.max_slam, fb.cand_ids.shape[0]
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=state.cov.device)
    st, uwb_acc, uwb_chi2 = _uwb_drain(state, fb, plan, cfg)

    st = propagate_and_clone(
        st, L, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises, cfg.gravity_mag,
        integration=cfg.integration, stamp_time=fb.stamp_time,
    )
    st, minfo = msckf_update(
        st, L, cfg.cam_model, fb.msckf_uv, fb.msckf_mask, sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult
    )
    cov_ok = minfo["cov_ok"]

    slam_kept, slam_failed, slam_inited = zeros(S), zeros(S), zeros(Fc)
    slam_chi2 = torch.zeros((S,), dtype=st.cov.dtype, device=st.cov.device)
    init_chi2 = torch.zeros((Fc,), dtype=st.cov.dtype, device=st.cov.device)
    if S > 0:
        st, sinfo = slam_update(
            st, L, fb.slam_uv, fb.slam_mask, cfg.cam_model,
            sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult,
        )
        cov_ok = cov_ok & sinfo["cov_ok"]
        slam_kept, slam_failed, slam_chi2 = sinfo["kept"], sinfo["failed"], sinfo["chi2"]
        if plan.slam_init:
            st, ii = slam_delayed_init(
                st, L, fb.cand_uv, fb.cand_mask, fb.cand_slots, fb.cand_ids, cfg.cam_model,
                sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult,
            )
            slam_inited, init_chi2 = ii["inited"], ii["chi2"]

    if plan.marg:
        if S > 0:  # a no-op for the global representations
            st = anchor_change(st, L, fb.marg_slot, st.clone_head)
        st = marginalize_clone(st, L, fb.marg_slot)

    infos = {
        "msckf": minfo,
        "slam_kept": slam_kept,
        "slam_failed": slam_failed,
        "slam_inited": slam_inited,
        "uwb_accepted": uwb_acc,
        "cov_ok": cov_ok,
        # the gates' chi2 statistics, beyond uvio_tpu's infos
        "slam_chi2": slam_chi2,
        "slam_init_chi2": init_chi2,
        "uwb_chi2": uwb_chi2,
    }
    return st, infos


def full_filter_step(state: FilterState, fb: FrameBundle, plan: FramePlan, *, cfg: FullStepConfig):
    """One complete camera-frame step (module docstring). Returns
    (new_state, infos): zupt_accepted, msckf tri_ok/kept/num_used/cov_ok,
    slam kept/failed/inited, uwb accepted, cov_ok as `uvio_tpu` returns
    them, and the gates' chi2 statistics (msckf chi2, slam_chi2,
    slam_init_chi2, uwb_chi2)."""
    L = cfg.layout
    st_v, infos = _visual(state, fb, plan, cfg)
    if not (cfg.try_zupt and plan.zupt_try):
        infos["zupt_accepted"] = torch.zeros((), dtype=torch.bool, device=state.cov.device)
        return st_v, infos

    kwargs = dict(
        chi2_mult=cfg.zupt_chi2_mult, noise_mult=cfg.zupt_noise_mult,
        max_velocity=cfg.zupt_max_velocity, stamp_time=fb.stamp_time,
    )
    zargs = (state, L, fb.zupt_imu_t, fb.zupt_imu_w, fb.zupt_imu_a, cfg.noises, cfg.gravity_mag)
    if cfg.zupt_explicit:
        st_z, z_acc, _ = zupt_explicit_update(*zargs, integration=cfg.integration, **kwargs)
    else:
        st_z, z_acc, _ = zupt_try_update(*zargs, **kwargs)
    # an accepted ZUPT skips the visual part: select its state and the
    # infos of a frame with no visual update
    infos = {**_select_infos(z_acc, _skipped(infos), infos), "zupt_accepted": z_acc}
    return where_state(z_acc, st_z, st_v), infos


def make_full_step(cfg: FullStepConfig):
    """The full step, `step(state, fb, plan) -> (state, infos)`. Raises
    unless float32 matmuls run in full precision (README "Numerics")."""
    check_full_precision()
    if cfg.integration not in INTEGRATIONS:
        raise ValueError(f"integration {cfg.integration!r} is not one of {INTEGRATIONS}")
    return lambda state, fb, plan: full_filter_step(state, fb, plan, cfg=cfg)

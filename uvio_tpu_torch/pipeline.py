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

Batches of independent sequences (Monte-Carlo runs, dataset
evaluation): `make_batched_step` is `filter_step` and
`make_batched_full_step` is `full_filter_step` under `torch.func.vmap`
over a leading sequence axis B, as `uvio_tpu` runs them under `jax.vmap`.
Under `jax.vmap` every `lax.cond` becomes a select over both branches. B
sequences have B plans, so the batched full step runs each branch that
any sequence's plan runs (`BatchPlan.union`) and then, per sequence,
selects between the branch's result and its input by that sequence's own
decision (`BatchPlan`'s bit tensors, which `stack_bundles` uploads with
the bundles). Given a `torch.distributed` process group, both split the
batch into equal contiguous slices in rank order, step each rank's slice
and all-gather the results: `uvio_tpu`'s sharding of the batch over mesh
axis "dp".
`HostPipeline` stages chunk k+1 on the device from a thread while the
caller runs chunk k.

On the card every factory's step is `uvio_tpu`'s `jax.jit` counterpart:
`graphs.graphed`, one CUDA graph captured per static key (the plan's
bools, the batch's union plan, the input shapes and dtypes) and replayed
after; `step.eager` is the plain step, and `full_filter_step` and
`filter_step` stay the plain functions. So are the managers' staged
stages, UWB drain and IMU-rate pose output (`manager._stage`) and the
trackers' device steps (`frontend/tracker.py`, `frontend/descriptor.py`).
What stays eager on the card, and why:

| step | where | why |
|---|---|---|
| `augment_clone` of the in-motion init | `manager.py` `_try_dynamic_init` | once per init: a graph would be captured and never replayed (`uvio_tpu`'s `_jit_clone_only`) |
| the init replays' propagate+clone and marginalization | `_try_static_init`, `_try_dynamic_init`: `_propagate_clone` / `_marginalize` with `eager=True` | at most a window of frames, once: a capture costs two to three eager frames a key, and none lands at the moment the filter starts |
| RANSAC over the descriptor matches and over the left<->right stereo matches | `frontend/descriptor.py`, `frontend/stereo.py` `feed` | the number of pairs is known only on the host (both run outside `uvio_tpu`'s jits too) |
| the batched steps given a process group | `make_batched_step`, `make_batched_full_step` | a gloo collective cannot be captured |

With tracing on (`tracing.py`), the full step marks the end of each
stage it runs on the device: `unpack` (the packed bundle's fields),
`uwb_drain`, `propagate_clone`, `msckf`, `slam`, `marginalize`, `zupt`.
Captured, each mark is an event node of the graph; a stage the plan does
not run has no mark.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from .device import resolve_device
from .filter.ekf import marginalize_clone
from .filter.propagator import INTEGRATIONS, NoiseManager, propagate_and_clone, propagate_mean_cov
from .frontend.fused_vio import check_full_precision
from .graphs import graphed
from .tracing import mark
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
    obs_mask)`: `filter_step` captured as a CUDA graph per input shape and
    replayed (`graphs.graphed`, the port's `jax.jit`); `step.eager` is
    `filter_step` itself."""
    check_full_precision()
    return graphed(partial(filter_step, cfg=cfg), "filter_step")


def _over_batch(fn, group, *args, **kwargs):
    """`torch.func.vmap(fn)(*args, **kwargs)` over the leading axis of
    every tensor in `args` (`kwargs` pass unbatched). With a process group
    the batch is split into equal contiguous slices in rank order: this
    rank steps its slice, and one `all_gather` of the packed results
    returns the whole batch on every rank."""
    if group is None:
        return torch.func.vmap(fn)(*args, **kwargs)
    import torch.distributed as dist
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    B = tree_flatten(args)[0][0].shape[0]
    if B % world:
        raise ValueError(f"a batch of {B} sequences does not split evenly over {world} ranks")
    n = B // world
    out = torch.func.vmap(fn)(*tree_map(lambda x: x[rank * n : (rank + 1) * n], args), **kwargs)
    leaves, spec = tree_flatten(out)
    # float64 holds every float32, bool and index exactly
    flat = torch.cat([x.reshape(-1).to(torch.float64) for x in leaves])
    parts = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(parts, flat, group=group)
    per_rank = [torch.split(p, [x.numel() for x in leaves]) for p in parts]
    return tree_unflatten(
        [torch.cat([r[i].reshape(x.shape) for r in per_rank]).to(x.dtype) for i, x in enumerate(leaves)],
        spec,
    )


def make_batched_step(cfg: StepConfig, group=None):
    """`filter_step` over a leading sequence-batch axis (multi-sequence
    Monte-Carlo / dataset evaluation): `step(state, imu_t, imu_w, imu_a,
    obs_uv, obs_mask)` with a leading axis B on every state field and
    input, returning the batched state and infos. With a
    `torch.distributed` process group (the "dp" axis, e.g.
    `torch.distributed.group.WORLD`) each rank steps B / world sequences
    and every rank returns the whole batch; B must divide evenly.

    `torch.func.vmap` rather than a written-out batch dimension: the step
    is the single-sequence code, so the batched step cannot drift from
    it. Its in-place block writes stay batched under vmap because every
    buffer they write into is allocated from a batched tensor
    (`new_zeros`), and the step makes no data-dependent host decision.

    Without a group the step is captured as a CUDA graph per input shape
    and replayed (`graphs.graphed`; `.eager` is the vmap itself). With a
    group it runs eagerly: a gloo collective cannot be captured.
    """
    check_full_precision()

    def one(fields, *args):
        st, info = filter_step(FilterState(**dict(zip(FIELDS, fields))), *args, cfg=cfg)
        return tuple(getattr(st, n) for n in FIELDS), info

    def step(state, *args):
        fields, info = _over_batch(one, group, tuple(getattr(state, n) for n in FIELDS), *args)
        return FilterState(**dict(zip(FIELDS, fields))), info

    return step if group is not None else graphed(step, "batched filter_step")


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


def _getter(fields):
    return fields.__getitem__ if isinstance(fields, dict) else lambda n: getattr(fields, n)


def _host_flat(arrays, device) -> torch.Tensor:
    """The numpy `arrays` packed into one float64 host tensor (which holds
    every mask and index exactly), in pinned memory when `device` is a
    CUDA device, so that its copy to the card need not wait for it."""
    flat = torch.empty(sum(a.size for a in arrays), dtype=torch.float64,
                       pin_memory=device.type == "cuda")
    np.concatenate([a.ravel() for a in arrays], out=flat.numpy(), casting="unsafe")
    return flat


def _split(flat, shapes):
    """Views of `flat` with the given shapes, in order."""
    sizes = [math.prod(s) for s in shapes]
    return [x.view(s) for x, s in zip(torch.split(flat, sizes), shapes)]


def _upload(arrays, device):
    """The numpy `arrays` on `device` as float64 tensors of their shapes,
    in one copy (`_host_flat`), which on a CUDA device does not wait for
    the device, so a caller that reads nothing back keeps running ahead
    of it."""
    flat = _host_flat(arrays, device)
    if device.type == "cuda":
        flat = flat.to(device, non_blocking=True)
    return _split(flat, [a.shape for a in arrays])


def _bundle_leaves(parts, dtype) -> FrameBundle:
    def conv(name, x):
        if name in _TIME_FIELDS:
            return x
        if name in _BOOL_FIELDS:
            return x != 0
        return x.to(torch.int64 if name in _INT_FIELDS else dtype)

    return FrameBundle(*(conv(n, x) for n, x in zip(FrameBundle._fields, parts)))


def bundle_from_numpy(fields, device=None, dtype=torch.float64) -> FrameBundle:
    """A `FrameBundle` on `device` (None: `default_device()`, the card or
    an error) from numpy arrays keyed by field name
    (a mapping, or a bundle of numpy leaves such as `uvio_tpu`'s). Times
    stay float64, masks bool, indices int64; the rest takes `dtype`. The
    leaves cross to the device together, in one copy (`_upload`).
    """
    get = _getter(fields)
    leaves = [np.asarray(get(n)) for n in FrameBundle._fields]
    return _bundle_leaves(_upload(leaves, resolve_device(device)), dtype)


def pack_bundle(fields, device=None):
    """(flat, shapes): the numpy bundle `fields` (as `bundle_from_numpy`
    takes it) packed into one float64 host tensor, pinned for a CUDA
    `device`, and its fields' shapes. `make_packed_full_step`'s step
    takes both, and the flat copy goes to the card straight into the
    graph's static input: the frame's one upload."""
    get = _getter(fields)
    leaves = [np.asarray(get(n)) for n in FrameBundle._fields]
    return _host_flat(leaves, resolve_device(device)), tuple(a.shape for a in leaves)


def stack_bundles(bundles, plan, device=None, dtype=torch.float64):
    """(bundle, plan) of one frame of B sequences on `device`, in one
    copy: the B bundles (each as `bundle_from_numpy` takes it) as one
    `FrameBundle` with a leading axis B on every field, and their
    `BatchPlan` (`plan_batch`) with its bits as bool tensors."""
    gets = [_getter(b) for b in bundles]
    leaves = [np.stack([np.asarray(g(n)) for g in gets]) for n in FrameBundle._fields]
    bits = [np.asarray(getattr(plan, n), dtype=bool) for n in _PLAN_BITS]
    parts = _upload(leaves + bits, resolve_device(device))
    return _bundle_leaves(parts, dtype), plan._replace(**{n: x != 0 for n, x in zip(_PLAN_BITS, parts[len(leaves):])})


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


class BatchPlan(NamedTuple):
    """The plans of B sequences stepped together. `union` is what the
    batched step runs: a branch runs if any sequence's plan runs it. The
    other fields are each sequence's own decisions, (B,) or (B, U) bools
    (numpy from `plan_batch`, tensors once `stack_bundles` uploaded them):
    after a branch, a sequence whose own bit is off keeps the state it
    had before the branch and gets the infos of the skipped branch."""

    union: FramePlan
    zupt_try: Any  # (B,)
    uwb_rows: Any  # (B, U)
    slam_init: Any  # (B,)
    marg: Any  # (B,)


_PLAN_BITS = ("zupt_try", "uwb_rows", "slam_init", "marg")


def plan_batch(bundles, state_times) -> BatchPlan:
    """The `BatchPlan` of one frame of B sequences: `plan_frame` of each
    sequence's numpy bundle at its own state time before the step (after
    a step, a sequence's state time is its bundle's `stamp_time`)."""
    plans = [plan_frame(b, t) for b, t in zip(bundles, state_times, strict=True)]
    if not plans:
        raise ValueError("a batch needs at least one sequence")
    U = len(plans[0].uwb_rows)
    bits = {n: np.array([getattr(p, n) for p in plans], dtype=bool) for n in _PLAN_BITS}
    bits["uwb_rows"] = bits["uwb_rows"].reshape(len(plans), U)
    union = FramePlan(
        zupt_try=bool(bits["zupt_try"].any()),
        uwb_rows=tuple(bool(r) for r in bits["uwb_rows"].any(axis=0)),
        slam_init=bool(bits["slam_init"].any()),
        marg=bool(bits["marg"].any()),
    )
    return BatchPlan(union, **bits)


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


def _own(bit, after, before):
    """`after`; in a batched step (`bit` not None), `before` for a
    sequence whose own plan skips the branch (a state or a tensor). A
    select, never a product with a mask: a skipped sequence's branch
    result may be non-finite."""
    if bit is None:
        return after
    if isinstance(after, FilterState):
        return where_state(bit, after, before)
    return torch.where(bit, after, before)


def _uwb_drain(st, fb, plan, cfg, own=None):
    """Per UWB range set the plan runs: propagate (no clone) to its stamp,
    then the sequential range updates. Returns (state, accepted (U,A),
    chi2 (U,A); zeros on rows the plan skips). `own`: a sequence's
    `BatchPlan` bits in a batched step, else None."""
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
        before = st
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
        run = None if own is None else own.uwb_rows[k]
        st = _own(run, st, before)
        rows.append(_own(run, info["accepted"], zeros(A)))
        chi2.append(_own(run, info["chi2"], no_chi2))
    return st, torch.stack(rows), torch.stack(chi2)


def _visual(state, fb, plan, cfg, own=None):
    """UWB drain -> propagate+clone -> MSCKF -> SLAM -> marginalization.
    `own`: a sequence's `BatchPlan` bits in a batched step, else None."""
    L = cfg.layout
    S, Fc = L.max_slam, fb.cand_ids.shape[0]
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=state.cov.device)
    bit = lambda name: None if own is None else getattr(own, name)
    st, uwb_acc, uwb_chi2 = _uwb_drain(state, fb, plan, cfg, own)
    if any(plan.uwb_rows):
        mark("uwb_drain")

    st = propagate_and_clone(
        st, L, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises, cfg.gravity_mag,
        integration=cfg.integration, stamp_time=fb.stamp_time,
    )
    mark("propagate_clone")
    st, minfo = msckf_update(
        st, L, cfg.cam_model, fb.msckf_uv, fb.msckf_mask, sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult
    )
    mark("msckf")
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
            st_i, ii = slam_delayed_init(
                st, L, fb.cand_uv, fb.cand_mask, fb.cand_slots, fb.cand_ids, cfg.cam_model,
                sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult,
            )
            st = _own(bit("slam_init"), st_i, st)
            slam_inited = _own(bit("slam_init"), ii["inited"], slam_inited)
            init_chi2 = _own(bit("slam_init"), ii["chi2"], init_chi2)
        mark("slam")

    if plan.marg:
        st_m = st
        if S > 0:  # a no-op for the global representations
            st_m = anchor_change(st_m, L, fb.marg_slot, st_m.clone_head)
        st = _own(bit("marg"), marginalize_clone(st_m, L, fb.marg_slot), st)
        mark("marginalize")

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


def full_filter_step(state: FilterState, fb: FrameBundle, plan, *, cfg: FullStepConfig):
    """One complete camera-frame step (module docstring). Returns
    (new_state, infos): zupt_accepted, msckf tri_ok/kept/num_used/cov_ok,
    slam kept/failed/inited, uwb accepted, cov_ok as `uvio_tpu` returns
    them, and the gates' chi2 statistics (msckf chi2, slam_chi2,
    slam_init_chi2, uwb_chi2).

    `plan` is the bundle's `FramePlan`, or, for one sequence of a batched
    step (under vmap), a `BatchPlan` whose bits are that sequence's: the
    step then runs the union's branches and keeps each one's result only
    where the sequence's own bit is set."""
    L = cfg.layout
    own = plan if isinstance(plan, BatchPlan) else None
    if own is not None:
        plan = own.union
    st_v, infos = _visual(state, fb, plan, cfg, own)
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
    if own is not None:  # a sequence that did not try accepts nothing
        z_acc = z_acc & own.zupt_try
    mark("zupt")
    # an accepted ZUPT skips the visual part: select its state and the
    # infos of a frame with no visual update
    infos = {**_select_infos(z_acc, _skipped(infos), infos), "zupt_accepted": z_acc}
    return where_state(z_acc, st_z, st_v), infos


def _check_full_step(cfg: FullStepConfig):
    check_full_precision()
    if cfg.integration not in INTEGRATIONS:
        raise ValueError(f"integration {cfg.integration!r} is not one of {INTEGRATIONS}")


def make_full_step(cfg: FullStepConfig):
    """The full step, `step(state, fb, plan) -> (state, infos)`:
    `full_filter_step` captured as a CUDA graph once per `FramePlan` (and
    input dtype) and replayed after, one graph launch a frame
    (`graphs.graphed`, the port's `jax.jit`); `step.eager` is the plain
    step. Raises unless float32 matmuls run in full precision (README
    "Numerics")."""
    _check_full_step(cfg)
    return graphed(partial(full_filter_step, cfg=cfg), "full_filter_step")


def _packed_full_step(state, flat, shapes, plan, *, cfg: FullStepConfig):
    # a no-op inside the graph, whose static input is on the card already
    flat = flat.to(state.cov.device, non_blocking=True)
    fb = _bundle_leaves(_split(flat, shapes), state.cov.dtype)
    mark("unpack")
    return full_filter_step(state, fb, plan, cfg=cfg)


def make_packed_full_step(cfg: FullStepConfig):
    """The full step on a bundle packed by `pack_bundle`, `step(state,
    flat, shapes, plan) -> (state, infos)`, graphed as `make_full_step`:
    the flat host tensor is copied straight into the graph's static input
    and unpacked inside the graph. Its float fields take the state's
    dtype. The managers' fused frame."""
    _check_full_step(cfg)
    return graphed(partial(_packed_full_step, cfg=cfg), "full_filter_step (packed bundle)")


def make_batched_full_step(cfg: FullStepConfig, group=None):
    """`full_filter_step` over B independent sequences,
    `step(state, fb, plan) -> (state, infos)`: a leading axis B on every
    state field, bundle field and info; `fb` and `plan` from
    `stack_bundles(bundles, plan_batch(bundles, state_times))`.
    `uvio_tpu`'s `jax.vmap(full_filter_step)`: each sequence's state and
    infos are those of the single step on that sequence alone. With a
    `torch.distributed` process group each rank steps B / world sequences
    and every rank returns the whole batch; B must divide evenly.

    One `torch.func.vmap` of the single-sequence code, nothing else: an
    operation that vmap cannot batch raises, and no sequence is ever
    stepped on its own. Without a group it is captured as a CUDA graph
    once per union plan (and input shape) and replayed
    (`graphs.graphed`; `.eager` is the vmap itself); with a group it runs
    eagerly, since a gloo collective cannot be captured. Raises unless
    float32 matmuls run in full precision, as `make_full_step`."""
    _check_full_step(cfg)

    def one(fields, fb, bits, union):
        st, infos = full_filter_step(FilterState(**dict(zip(FIELDS, fields))), fb,
                                     BatchPlan(union, *bits), cfg=cfg)
        return tuple(getattr(st, n) for n in FIELDS), infos

    def step(state, fb, plan):
        fields, infos = _over_batch(one, group, tuple(getattr(state, n) for n in FIELDS), fb,
                                    tuple(getattr(plan, n) for n in _PLAN_BITS), union=plan.union)
        return FilterState(**dict(zip(FIELDS, fields))), infos

    return step if group is not None else graphed(step, "batched full_filter_step")

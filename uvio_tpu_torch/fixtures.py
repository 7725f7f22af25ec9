"""The committed replay fixture of the full filter step, read with numpy
alone (no JAX).

`fixtures/full_step_seed7.npz` holds `bench.py`'s scenario as `uvio_tpu`
captured and replayed it (seed 7, 12 clone slots, 25 SLAM slots of
anchored inverse depth, 4 UWB anchors, 4 range sets and 40 MSCKF
features per frame, 64-sample IMU windows): the state after 20 warm-up
frames, the next 100 `FrameBundle`s, and per-frame results of the JAX
replays in float64 and float32. `fixtures/manager_ckpt_seed7.npz` is a
checkpoint that `uvio_tpu`'s `UVioManager` saved after frame 20 of the
same scenario run live (it loads with `UVioManager.load_checkpoint`),
with the poses of a JAX manager that restored it and ran frames 21-30.
`scripts/make_full_step_fixture.py` writes both.

`fixtures/staged_seed7.npz` holds the same scenario run live through
`uvio_tpu`'s staged `UVioManager` (`fused_step=False`, float64): per frame
after 20 warm-up frames, the `staged_record` of the manager.
`scripts/make_staged_fixture.py` writes it.

`fixtures/batched_seeds.npz` holds the same scenario under four seeds,
each after its own warm-up, stacked into one batch of four independent
sequences, and per frame and sequence the results of `uvio_tpu`'s
`jax.vmap(full_filter_step)` replays of that batch in float64 and
float32. `scripts/make_batched_fixture.py` writes it.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

FULL_STEP_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "full_step_seed7.npz")
MANAGER_CKPT_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "manager_ckpt_seed7.npz")
STAGED_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "staged_seed7.npz")
BATCHED_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "batched_seeds.npz")
# the staged fixture's scenario: frames of warm-up, then recorded frames
STAGED_WARM, STAGED_FRAMES = 20, 60


@dataclasses.dataclass(frozen=True)
class FullStepFixture:
    config: dict  # dataclasses.asdict of the FullStepConfig
    state0: dict  # state field -> array
    bundles: list  # per frame: bundle field -> array
    replays: dict  # "f64"/"f32" -> info -> (frames, ...) array
    snapshots: dict  # frame k -> state field -> array (float64 replay, before bundle k)
    gt_p: np.ndarray  # (frames, 3) ground-truth position at each stamp_time


def load_full_step_fixture(path: str = FULL_STEP_FIXTURE) -> FullStepFixture:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}

    def group(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix)}

    fb = group("fb_")
    n_frames = len(fb["stamp_time"])
    snaps = {}
    for k in arrays:
        if k.startswith("snap"):
            frame = int(k[4 : k.index("_")])
            snaps.setdefault(frame, group(f"snap{frame}_"))
    return FullStepFixture(
        config=json.loads(str(arrays["config_json"])),
        state0=group("state0_"),
        bundles=[{name: v[i] for name, v in fb.items()} for i in range(n_frames)],
        replays={"f64": group("f64_"), "f32": group("f32_")},
        snapshots=snaps,
        gt_p=arrays["gt_p"],
    )


@dataclasses.dataclass(frozen=True)
class BatchedFixture:
    config: dict  # dataclasses.asdict of the FullStepConfig
    seeds: np.ndarray  # (B,)
    warm: np.ndarray  # (B,) warm-up frames before state0
    state0: dict  # state field -> (B, ...) array
    bundles: list  # per frame: the B sequences' bundles, bundle field -> array
    replays: dict  # "f64"/"f32" -> key -> (frames, B, ...) array


def load_batched_fixture(path: str = BATCHED_FIXTURE) -> BatchedFixture:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}

    def group(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix)}

    fb = group("fb_")
    n_frames, B = fb["stamp_time"].shape
    return BatchedFixture(
        config=json.loads(str(arrays["config_json"])),
        seeds=arrays["seeds"],
        warm=arrays["warm"],
        state0=group("state0_"),
        bundles=[[{name: v[k, b] for name, v in fb.items()} for b in range(B)] for k in range(n_frames)],
        replays={"f64": group("f64_"), "f32": group("f32_")},
    )


def stage_batched_fixture(fx: BatchedFixture, B=None, frames=None, device=None, dtype=None):
    """(state0, [(bundle, plan)] a frame): the fixture's sequences tiled
    to B (all of them by default) as the inputs of
    `pipeline.make_batched_full_step`, the first `frames` frames (all by
    default) staged on `device` (None: the card) in `dtype` (float32 by
    default)."""
    import torch

    from .pipeline import plan_batch, stack_bundles
    from .types.state import state_from_numpy

    dtype = dtype or torch.float32
    idx = [b % len(fx.seeds) for b in range(B or len(fx.seeds))]
    state0 = {k: v[idx] for k, v in fx.state0.items()}
    times, staged = [float(t) for t in state0["time"]], []
    for frame in fx.bundles[:frames]:
        bs = [frame[i] for i in idx]
        staged.append(stack_bundles(bs, plan_batch(bs, times), device, dtype))
        times = [float(b["stamp_time"]) for b in bs]
    return state_from_numpy(state0, device, dtype), staged


def load_manager_ckpt_reference(path: str = MANAGER_CKPT_FIXTURE) -> dict:
    """The poses of the JAX manager that restored the checkpoint fixture:
    `ref_t` (10,), `ref_q` (10,4), `ref_p` (10,3), after frames 21-30."""
    with np.load(path) as z:
        return {k: z[k] for k in ("ref_t", "ref_q", "ref_p")}


def staged_record(mgr, t: float, as_np, msckf_before) -> dict:
    """One frame of a staged (U)VioManager of either package, as numpy: the
    stamp `t`, position `p`, quaternion `q`, `cov_trace`; `msckf_ran`
    (whether `last_msckf_info` changed during the frame: it was
    `msckf_before` before it), `msckf_num_used`, `msckf_kept`; the SLAM
    maps per slot, `slam_fid` (-1 free) and `slam_fail`; the accept flags
    of the frame's last drained UWB range set, `uwb_accepted`, and the
    range sets still buffered, `uwb_buffered`. `as_np` turns one of the
    manager's arrays into numpy."""
    st = mgr.state
    S = mgr.layout.max_slam
    A = getattr(mgr.layout, "max_anchors", 0)
    info = mgr.__dict__.get("last_msckf_info")
    uwb = mgr.__dict__.get("last_uwb_info")
    fid, fail = np.full(S, -1, np.int64), np.zeros(S, np.int64)
    for f, slot in mgr.slam_slot_by_fid.items():
        fid[slot], fail[slot] = f, mgr.slam_fail.get(f, 0)
    return {
        "t": np.float64(t),
        "p": as_np(st.p).astype(np.float64),
        "q": as_np(st.q).astype(np.float64),
        "cov_trace": np.float64(as_np(st.cov.trace())),
        "msckf_ran": np.bool_(info is not None and info is not msckf_before),
        "msckf_num_used": np.int64(as_np(info["num_used"]) if info is not None else 0),
        "msckf_kept": (as_np(info["kept"]) if info is not None
                       else np.zeros(mgr.cfg.max_msckf_in_update)).astype(bool),
        "slam_fid": fid,
        "slam_fail": fail,
        "uwb_accepted": (as_np(uwb["accepted"]) if uwb is not None else np.zeros(A)).astype(bool),
        "uwb_buffered": np.int64(len(getattr(mgr, "uwb_buffer", []))),
    }


def load_staged_fixture(path: str = STAGED_FIXTURE) -> dict:
    """`staged_record` key -> (frames, ...) array, `uvio_tpu`'s staged run."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


STAGED_EXACT = ("t", "msckf_ran", "msckf_num_used", "msckf_kept", "slam_fid", "slam_fail",
                "uwb_accepted", "uwb_buffered")


def staged_differences(got: dict, ref: dict) -> dict:
    """How far stacked `staged_record`s `got` are from `ref` (both key ->
    (frames, ...) arrays, `got` possibly shorter): the largest position
    difference `p_m`, quaternion difference `q`, relative covariance-trace
    difference `cov_trace_rel`, and `decisions`, the exact keys that
    differ with the first frame where each does."""
    n = len(got["t"])
    ref = {k: v[:n] for k, v in ref.items()}
    bad = {}
    for k in STAGED_EXACT:
        rows = np.nonzero(~np.all((got[k] == ref[k]).reshape(n, -1), axis=1))[0]
        if rows.size:
            bad[k] = int(rows[0])
    return {
        "p_m": float(np.abs(got["p"] - ref["p"]).max()),
        "q": float(np.abs(got["q"] - ref["q"]).max()),
        "cov_trace_rel": float(np.abs(got["cov_trace"] / ref["cov_trace"] - 1.0).max()),
        "decisions": bad,
    }

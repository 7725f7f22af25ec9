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
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

FULL_STEP_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "full_step_seed7.npz")
MANAGER_CKPT_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "manager_ckpt_seed7.npz")


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


def load_manager_ckpt_reference(path: str = MANAGER_CKPT_FIXTURE) -> dict:
    """The poses of the JAX manager that restored the checkpoint fixture:
    `ref_t` (10,), `ref_q` (10,4), `ref_p` (10,3), after frames 21-30."""
    with np.load(path) as z:
        return {k: z[k] for k in ("ref_t", "ref_q", "ref_p")}

#!/usr/bin/env python3
"""Write the replay fixture of the full filter step,
`uvio_tpu_torch/fixtures/full_step_seed7.npz`, and beside it the manager
checkpoint fixture `manager_ckpt_seed7.npz`.

    JAX_PLATFORMS=cpu python scripts/make_full_step_fixture.py [--out PATH]

Runs `uvio_tpu` (JAX, on the CPU) once: `capture_sim_bundles` gives the
`bench.py` scenario (seed 7, 25 SLAM slots, 4 biased UWB anchors; 20
warm-up frames, then 100 captured `FrameBundle`s) in float64. The 100
bundles are replayed through `pipeline.full_filter_step` twice from the
same state: in float64, and with the state cast to float32 (time stays
float64), the precision `bench.py` runs. The simulator is rebuilt to
read the ground-truth position at each bundle's stamp.

The file holds, as plain numpy arrays (`uvio_tpu_torch.fixtures` loads
it without JAX):
  config_json        the FullStepConfig, its StateLayout and noises
  state0_<field>     the state before the first bundle
  fb_<field>         the 100 bundles, stacked field by field
  f64_<info>, f32_<info>   per frame of each replay: q, p, v, num_used,
                     msckf_kept, slam_kept, slam_failed, slam_inited,
                     uwb_accepted, cov_ok, cov_trace, slam_valid
  snap<k>_<field>    the float64 replay's state before bundle k, for k in
                     SNAPSHOTS (one SLAM landmark and 8 candidates; all 25
                     slots full)
  gt_p               ground-truth position at each bundle's stamp_time

The second file, written into the same directory, carries an estimator
from `uvio_tpu` to the port: the same scenario is run live once more, the
JAX `UVioManager` saves a checkpoint after frame 20 (`CKPT_FRAME`), a
fresh JAX manager loads it and runs frames 21-30. The file is that
checkpoint, entry for entry (`state/<field>`, `__meta__`; compressed),
plus `ref_t`, `ref_q`, `ref_p`: the restored manager's pose after each of
the 10 frames.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

SEED, N_WARM, N_BENCH, MAX_SLAM = 7, 20, 100, 25
SNAPSHOTS = (3, 16)
CKPT_FRAME, CKPT_MORE = 20, 10
CKPT_NAME = "manager_ckpt_seed7.npz"
ANCHORS = {
    1: (np.array([4.0, 4.0, 2.0]), 0.15, 0.01),
    2: (np.array([-4.0, 4.0, 0.5]), -0.1, 0.005),
    3: (np.array([-4.0, -4.0, 2.5]), 0.2, 0.0),
    4: (np.array([4.0, -4.0, 1.0]), 0.0, 0.02),
}
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "uvio_tpu_torch", "fixtures",
    "full_step_seed7.npz",
)


def _simulator():
    """The capture's simulator (same seed, anchors and duration)."""
    from uvio_tpu.sim import SimParams, Simulator, circle_trajectory

    return Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=60, seed=SEED,
                  uwb_anchors=ANCHORS),
        trajectory=circle_trajectory(duration=(N_WARM + N_BENCH) / 10.0 + 8.0),
    )


def _ground_truth(stamps):
    """The simulator's position at each stamp."""
    sim = _simulator()
    return np.stack([sim.get_gt_state(float(t))["p_IinG"] for t in stamps])


def _manager(sim, **overrides):
    """The capture's `UVioManager` (`uvio_tpu/eval/capture.py`), float64;
    `overrides` are further `UVioConfig` fields."""
    from uvio_tpu.manager import CameraConfig
    from uvio_tpu.uwb_manager import AnchorConfig, UVioConfig, UVioManager

    cam = sim.params.cameras[0]
    rng = np.random.default_rng(1)
    anchors = [
        AnchorConfig(anchor_id=aid, p_AinG=p + rng.normal(scale=0.05, size=3),
                     prior_cov=np.diag([0.05**2] * 3 + [0.25**2, 0.025**2]))
        for aid, (p, g, a) in ANCHORS.items()
    ]
    return UVioManager(UVioConfig(
        max_clones=11, max_msckf_in_update=40, max_slam=MAX_SLAM, sigma_pix=sim.params.sigma_pix,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC,
                              p_IinC=cam.p_IinC)],
        max_anchors=len(anchors), anchors=anchors, sigma_range=sim.params.sigma_range,
        dtype="float64", **overrides,
    ))


def _drive(sim, mgr, n_frames, on_frame=None):
    """The capture's feeding loop for `n_frames` camera frames."""
    frames = 0
    while frames < n_frames:
        t, wm, am = sim.get_next_imu()
        mgr.feed_imu(t, wm, am)
        if sim.cur_uwb_t + 1.0 / sim.params.uwb_freq <= t:
            mgr.feed_uwb(*sim.get_next_uwb())
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            tc, obs = sim.get_next_cam()
            mgr.feed_features(tc, obs)
            frames += 1
            if on_frame is not None:
                on_frame(tc)


def make_manager_checkpoint(out):
    """Write the manager checkpoint fixture (module docstring) to `out`."""
    import tempfile

    t0 = time.perf_counter()
    sim = _simulator()
    mgr = _manager(sim)
    gt0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, gt0["q_GtoI"], gt0["p_IinG"], gt0["v_IinG"], gt0["bg"], gt0["ba"])
    _drive(sim, mgr, CKPT_FRAME)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        mgr.save_checkpoint(path)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        restored = _manager(sim)
        restored.load_checkpoint(path)
    ref = []
    _drive(sim, restored, CKPT_MORE,
           on_frame=lambda tc: ref.append((tc, np.asarray(restored.state.q), np.asarray(restored.state.p))))
    arrays["ref_t"] = np.array([r[0] for r in ref])
    arrays["ref_q"] = np.stack([r[1] for r in ref])
    arrays["ref_p"] = np.stack([r[2] for r in ref])
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {os.path.getsize(out)} bytes in {time.perf_counter() - t0:.1f} s", flush=True)


def _replay(step, state, bundles, snaps):
    """Per-frame records of one replay through the JAX step; the states
    before the bundles numbered in `snaps` go into `snaps`."""
    recs = []
    for k, fb in enumerate(bundles):
        if k in snaps:
            snaps[k] = state
        state, infos = step(state, fb)
        recs.append({
            "q": state.q, "p": state.p, "v": state.v,
            "num_used": infos["msckf"]["num_used"], "msckf_kept": infos["msckf"]["kept"],
            "slam_kept": infos["slam_kept"], "slam_failed": infos["slam_failed"],
            "slam_inited": infos["slam_inited"], "uwb_accepted": infos["uwb_accepted"],
            "cov_ok": infos["cov_ok"], "cov_trace": state.cov.trace(),
            "slam_valid": state.slam_valid,
        })
    return {k: np.stack([np.asarray(r[k]) for r in recs]) for k in recs[0]}


def make(out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import uvio_tpu  # noqa: F401  (x64)
    from uvio_tpu.eval.capture import capture_sim_bundles
    from uvio_tpu.pipeline import make_full_step

    t0 = time.perf_counter()
    cfg, state0, bundles = capture_sim_bundles(
        n_warm=N_WARM, n_bench=N_BENCH, seed=SEED, max_slam=MAX_SLAM, dtype="float64"
    )
    print(f"captured {len(bundles)} bundles in {time.perf_counter() - t0:.1f} s", flush=True)
    step = make_full_step(cfg)
    arrays = {"config_json": np.array(json.dumps(dataclasses.asdict(cfg)))}
    for name in state0.__dataclass_fields__:
        arrays[f"state0_{name}"] = np.asarray(getattr(state0, name))
    for name in bundles[0]._fields:
        arrays[f"fb_{name}"] = np.stack([np.asarray(getattr(fb, name)) for fb in bundles])

    t0 = time.perf_counter()
    snaps = dict.fromkeys(SNAPSHOTS)
    for k, v in _replay(step, state0, bundles, snaps).items():
        arrays[f"f64_{k}"] = v
    for k, st in snaps.items():
        for name in st.__dataclass_fields__:
            arrays[f"snap{k}_{name}"] = np.asarray(getattr(st, name))
    keep64 = ("time", "clones_t")

    def to32(name, a):
        a = jnp.asarray(a)
        return a.astype(jnp.float32) if a.dtype == jnp.float64 and name not in keep64 else a

    state32 = state0.replace(**{n: to32(n, getattr(state0, n)) for n in state0.__dataclass_fields__})
    for k, v in _replay(step, state32, bundles, {}).items():
        arrays[f"f32_{k}"] = v
    print(f"replayed f64 and f32 in {time.perf_counter() - t0:.1f} s", flush=True)
    arrays["gt_p"] = _ground_truth(arrays["fb_stamp_time"])

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {os.path.getsize(out)} bytes", flush=True)
    make_manager_checkpoint(os.path.join(os.path.dirname(os.path.abspath(out)), CKPT_NAME))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the replay fixture; the checkpoint fixture goes into its directory")
    make(ap.parse_args().out)


if __name__ == "__main__":
    main()

"""Port parity, the slice as a whole: `full_filter_step` and `filter_step`
against `uvio_tpu.pipeline`, in float64 on the CPU, on the committed
replay fixture (the `bench.py` scenario: seed 7, 25 SLAM slots of
anchored inverse depth, 4 UWB anchors, 4 range sets and 40 MSCKF features
per frame).

Tolerances: every gate decision (MSCKF triangulation and chi2, SLAM kept
/ failed / inited, UWB accepted, ZUPT accepted, covariance health) must
match exactly on every frame; the state and covariance agree to 1e-8
absolute after 20 chained frames (measured: ~1e-14 in position). QR
bases differ between LAPACK builds, so only these invariants are
compared, never Q or R.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvio_tpu.pipeline import FrameBundle as JBundle
from uvio_tpu.types.state import FilterState as JState

from uvio_tpu_torch.fixtures import load_full_step_fixture
from uvio_tpu_torch.pipeline import FullStepConfig, bundle_from_numpy, make_full_step, plan_frame
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy

torch.set_num_threads(1)

T64 = torch.float64
N_FRAMES = 20
STATE_FIELDS = ("q", "p", "v", "bg", "ba", "clones_q", "clones_p", "slam_p", "anchors_p",
                "anchors_gamma", "anchors_alpha", "cov")
INFO_KEYS = ("slam_kept", "slam_failed", "slam_inited", "uwb_accepted", "cov_ok", "zupt_accepted")
MSCKF_KEYS = ("num_used", "tri_ok", "kept", "cov_ok")


def _jstate(arrays):
    return JState(**{n: jnp.asarray(arrays[n]) for n in FIELDS})


def _jbundle(b):
    return JBundle(**{k: np.asarray(v) for k, v in b.items()})


def _jcfg(config, **changes):
    from uvio_tpu.filter.propagator import NoiseManager
    from uvio_tpu.pipeline import FullStepConfig as JCfg
    from uvio_tpu.types import StateLayout

    d = dict(config, layout=StateLayout(**config["layout"]), noises=NoiseManager(**config["noises"]))
    return JCfg(**{**d, **changes})


def _assert_infos_equal(ji, ti, frame):
    for k in MSCKF_KEYS:
        np.testing.assert_array_equal(np.asarray(ti["msckf"][k]), np.asarray(ji["msckf"][k]),
                                      err_msg=f"frame {frame} msckf {k}")
    for k in INFO_KEYS:
        np.testing.assert_array_equal(np.asarray(ti[k]), np.asarray(ji[k]), err_msg=f"frame {frame} {k}")


def _assert_state_close(js, ts, frame, atol=1e-8):
    back = state_to_numpy(ts)
    for n in ("clones_valid", "clone_head", "slam_valid", "slam_id", "slam_anchor_slot"):
        np.testing.assert_array_equal(back[n], np.asarray(getattr(js, n)), err_msg=f"frame {frame} {n}")
    for n in STATE_FIELDS:
        np.testing.assert_allclose(back[n], np.asarray(getattr(js, n)), rtol=0, atol=atol,
                                   err_msg=f"frame {frame} {n}")
    assert float(ts.time) == float(js.time)


@pytest.fixture(scope="module")
def fx():
    return load_full_step_fixture()


@pytest.fixture(scope="module")
def replay(fx):
    """Frames 0..19 through both steps from the same state0, each step
    fed its own package's previous state."""
    from uvio_tpu.pipeline import make_full_step as j_make

    torch.backends.cudnn.allow_tf32 = False  # make_full_step insists on full-float32 products
    jstep = j_make(_jcfg(fx.config))
    tstep = make_full_step(FullStepConfig.from_dict(fx.config))
    js, ts = _jstate(fx.state0), state_from_numpy(fx.state0, dtype=T64)
    frames = []
    for k in range(N_FRAMES):
        b = fx.bundles[k]
        plan = plan_frame(b, float(ts.time))
        js2, ji = jstep(js, _jbundle(b))
        ts2, ti = tstep(ts, bundle_from_numpy(b, dtype=T64), plan)
        frames.append(dict(bundle=b, plan=plan, j_before=js, j_after=js2, j_info=ji, t_after=ts2, t_info=ti))
        js, ts = js2, ts2
    return frames


def test_full_step_replay_matches(replay):
    """(a) every info equal and the state within 1e-8 on each of 20
    frames, and the window holds every event of the step."""
    for k, f in enumerate(replay):
        _assert_infos_equal(f["j_info"], f["t_info"], k)
        _assert_state_close(f["j_after"], f["t_after"], k)
    info = lambda key: np.stack([np.asarray(f["j_info"][key]) for f in replay])
    assert info("uwb_accepted").any(), "no UWB range accepted"
    assert info("slam_inited").any(), "no SLAM landmark initialized"
    assert info("slam_kept").any(), "no SLAM re-observation kept"
    moved = 0
    for f in replay:  # a landmark that stays in its slot and changes anchor
        b, a = f["j_before"], f["j_after"]
        same = np.asarray(b.slam_valid & a.slam_valid & (b.slam_id == a.slam_id))
        moved += int((same & np.asarray(b.slam_anchor_slot != a.slam_anchor_slot)).sum())
    assert moved > 0, "no anchor change moved a landmark"


def test_uwb_padding_rows(fx, replay):
    """(c) The host plan's row decisions equal uvio_tpu's predicate
    `any(mask) | (stamp > s.time)` on every row of frames 0..19, and a
    skipped padding row leaves the state bit-identical to a bundle
    without that row."""
    n_skipped = 0
    for k, f in enumerate(replay):
        t = f["j_before"].time
        b = f["bundle"]
        for row, (ts, rm) in enumerate(zip(b["uwb_stamp"], b["uwb_mask"])):
            pred = jnp.any(jnp.asarray(rm)) | (jnp.asarray(ts) > t)
            assert f["plan"].uwb_rows[row] == bool(pred), (k, row)
            t = jnp.where(pred, jnp.asarray(ts), t)
            n_skipped += not bool(pred)
    assert n_skipped >= N_FRAMES  # two padding rows per frame after frame 0

    k = 1
    b = fx.bundles[k]
    plan = plan_frame(b, float(replay[k]["j_before"].time))
    assert plan.uwb_rows == (True, True, False, False)
    step = make_full_step(FullStepConfig.from_dict(fx.config))
    st0 = state_from_numpy(state_to_numpy(replay[k - 1]["t_after"]), dtype=T64)
    full, info = step(st0, bundle_from_numpy(b, dtype=T64), plan)
    short = {n: (v[:2] if n.startswith("uwb_") else v) for n, v in b.items()}
    cut, _ = step(st0, bundle_from_numpy(short, dtype=T64), plan._replace(uwb_rows=plan.uwb_rows[:2]))
    for n in FIELDS:
        assert torch.equal(getattr(full, n), getattr(cut, n)), n
    assert not info["uwb_accepted"][2:].any()


def _stationary_window(fx, arrays, M=64, n=21):
    """A 0.1 s, 200 Hz IMU window of a body at rest in `arrays`' attitude
    (bias + gravity in the body frame), padded to M samples."""
    from uvio_tpu.math import quat_to_rot

    t0 = float(arrays["time"])
    t = t0 + np.arange(n) * 0.005
    g = np.asarray(quat_to_rot(jnp.asarray(arrays["q"]))) @ np.array([0.0, 0.0, fx.config["gravity_mag"]])
    w = np.tile(arrays["bg"], (n, 1))
    a = np.tile(arrays["ba"] + g, (n, 1))
    pad = M - n
    return (np.concatenate([t, np.full(pad, t[-1])]), np.concatenate([w, np.tile(w[-1], (pad, 1))]),
            np.concatenate([a, np.tile(a[-1], (pad, 1))]))


@pytest.fixture(scope="module")
def jax_zupt_step(fx):
    from uvio_tpu.pipeline import make_full_step as j_make

    return j_make(_jcfg(fx.config, try_zupt=True))


@pytest.mark.parametrize("stationary", [True, False])
def test_full_step_zupt_matches(fx, jax_zupt_step, stationary):
    """(b) With ZUPT on: a stationary window is accepted and skips the
    visual update; a moving one is rejected and the visual update runs.
    Both outcomes agree with uvio_tpu."""
    arrays = dict(fx.state0)
    b = dict(fx.bundles[0], zupt_try=np.bool_(True))
    if stationary:
        arrays.update(v=np.zeros(3), v_fej=np.zeros(3))
        b["zupt_imu_t"], b["zupt_imu_w"], b["zupt_imu_a"] = _stationary_window(fx, arrays)
    else:  # the frame's own window: the body moves at ~1 m/s
        b["zupt_imu_t"], b["zupt_imu_w"], b["zupt_imu_a"] = b["imu_t"], b["imu_w"], b["imu_a"]
    js, ji = jax_zupt_step(_jstate(arrays), _jbundle(b))
    torch.backends.cudnn.allow_tf32 = False
    tcfg = dataclasses.replace(FullStepConfig.from_dict(fx.config), try_zupt=True)
    ts, ti = make_full_step(tcfg)(state_from_numpy(arrays, dtype=T64), bundle_from_numpy(b, dtype=T64),
                                  plan_frame(b, float(arrays["time"])))
    assert bool(ti["zupt_accepted"]) == bool(ji["zupt_accepted"]) == stationary
    _assert_infos_equal(ji, ti, 0)
    _assert_state_close(js, ts, 0)
    if stationary:  # the visual part's infos are those of a frame without it
        assert int(ti["msckf"]["num_used"]) == 0 and not ti["uwb_accepted"].any()
    else:
        assert ti["uwb_accepted"].any()


@pytest.mark.parametrize("full_ring", [False, True])
def test_filter_step_matches(fx, full_ring):
    """(d) The MSCKF-only step on frames 0 and 1; with a full clone ring
    the oldest clone is marginalized first (a select in the port)."""
    from uvio_tpu.filter.propagator import NoiseManager as JN
    from uvio_tpu.pipeline import StepConfig as JStepConfig
    from uvio_tpu.pipeline import make_step as j_make
    from uvio_tpu.types import StateLayout as JL

    from uvio_tpu_torch.filter.propagator import NoiseManager as TN
    from uvio_tpu_torch.pipeline import StepConfig, make_step
    from uvio_tpu_torch.types import StateLayout as TL

    arrays = dict(fx.state0)
    if full_ring:
        free = ~arrays["clones_valid"]
        arrays["clones_valid"] = np.ones_like(free)
        arrays["clones_t"] = np.where(free, arrays["clones_t"][~free].min() - 0.1, arrays["clones_t"])
    c = fx.config
    jstep = j_make(JStepConfig(layout=JL(**c["layout"]), noises=JN(**c["noises"]), sigma_pix=c["sigma_pix"]))
    torch.backends.cudnn.allow_tf32 = False
    tstep = make_step(StepConfig(layout=TL(**c["layout"]), noises=TN(**c["noises"]), sigma_pix=c["sigma_pix"]))
    js, ts = _jstate(arrays), state_from_numpy(arrays, dtype=T64)
    for k in (0, 1):
        b = fx.bundles[k]
        args = [b[n] for n in ("imu_t", "imu_w", "imu_a", "msckf_uv", "msckf_mask")]
        js, ji = jstep(js, *map(jnp.asarray, args))
        ts, ti = tstep(ts, *(torch.as_tensor(np.array(a)) for a in args))
        for key in MSCKF_KEYS:
            np.testing.assert_array_equal(np.asarray(ti[key]), np.asarray(ji[key]), err_msg=f"{k} {key}")
        _assert_state_close(js, ts, k)


@pytest.mark.slow
def test_fixture_regenerates(tmp_path):
    """scripts/make_full_step_fixture.py alone rebuilds the committed
    fixture, array for array (about a minute on the CPU)."""
    import os
    import subprocess
    import sys

    from uvio_tpu_torch.fixtures import FULL_STEP_FIXTURE

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "full_step.npz"
    subprocess.run([sys.executable, os.path.join(root, "scripts", "make_full_step_fixture.py"),
                    "--out", str(out)], check=True, timeout=900,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    with np.load(out) as new, np.load(FULL_STEP_FIXTURE) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)
    assert os.path.getsize(FULL_STEP_FIXTURE) <= 2 * 1024 * 1024

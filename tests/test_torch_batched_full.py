"""Port parity, the batched full filter step: `make_batched_full_step`
(B independent sequences through one `torch.func.vmap` of
`full_filter_step`) against `jax.vmap(uvio_tpu.pipeline.full_filter_step)`
and against the port's own single step, float64 on the CPU.

The batch is `bench.py`'s scenario captured under three seeds at a small
width (4 SLAM slots), each sequence after its own number of warm-up
frames, so that the sequences' plans differ on some frame in a UWB row,
in SLAM delayed init and in marginalization (asserted): the batched step
runs the union of the plans and selects per sequence.

Tolerances: every info equal on every frame and sequence; the states
within 1e-9 of JAX's (measured ~1e-14) and within 1e-12 of the port's
single step on each sequence alone (the same arithmetic, batched). The
committed fixture `fixtures/batched_seeds.npz` (four seeds at full
width, 40 frames) replays under the gates of `chip_smoke.py`'s phase
`batch` (a): every info equal to JAX's vmapped float64 replay, position
within 1e-6 m, trace(cov) within 1e-6 relative.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvio_tpu_torch.fixtures import load_batched_fixture, stage_batched_fixture
from uvio_tpu_torch.pipeline import (
    FullStepConfig,
    bundle_from_numpy,
    make_batched_full_step,
    make_full_step,
    plan_batch,
    plan_frame,
    stack_bundles,
)
from uvio_tpu_torch.types.state import FIELDS, FilterState, state_from_numpy, state_to_numpy

torch.set_num_threads(1)
T64 = torch.float64
SEEDS, WARM, N_FRAMES, MAX_SLAM = (7, 8, 9), (10, 11, 3), 12, 4
STATE_FIELDS = ("q", "p", "v", "bg", "ba", "clones_q", "clones_p", "slam_p", "anchors_p",
                "anchors_gamma", "anchors_alpha", "cov")
EXACT_FIELDS = ("time", "clones_t", "clones_valid", "clone_head", "slam_valid", "slam_id",
                "slam_anchor_slot")
INFO_KEYS = ("slam_kept", "slam_failed", "slam_inited", "uwb_accepted", "cov_ok", "zupt_accepted")
MSCKF_KEYS = ("num_used", "tri_ok", "kept", "cov_ok")


def _jcfg(cfg: FullStepConfig, **changes):
    from uvio_tpu.filter.propagator import NoiseManager
    from uvio_tpu.pipeline import FullStepConfig as JCfg
    from uvio_tpu.types import StateLayout

    d = dataclasses.asdict(cfg)
    d.update(layout=StateLayout(**d["layout"]), noises=NoiseManager(**d["noises"]), **changes)
    return JCfg(**d)


def _jstate(stacked):
    from uvio_tpu.types.state import FilterState as JState

    return JState(**{n: jnp.asarray(stacked[n]) for n in FIELDS})


def _jbundle(bundles):
    from uvio_tpu.pipeline import FrameBundle as JBundle

    return JBundle(**{k: np.stack([np.asarray(b[k]) for b in bundles]) for k in JBundle._fields})


def _stacked(state):
    return {n: np.asarray(getattr(state, n)) for n in FIELDS}


def _assert_infos_equal(ti, ji, what):
    for k in MSCKF_KEYS:
        np.testing.assert_array_equal(np.asarray(ti["msckf"][k]), np.asarray(ji["msckf"][k]),
                                      err_msg=f"{what} msckf {k}")
    for k in INFO_KEYS:
        np.testing.assert_array_equal(np.asarray(ti[k]), np.asarray(ji[k]), err_msg=f"{what} {k}")


def _assert_states_close(got, ref, atol, what):
    """`got`, `ref`: field -> array with a leading batch axis."""
    for n in EXACT_FIELDS:
        np.testing.assert_array_equal(got[n], ref[n], err_msg=f"{what} {n}")
    for n in STATE_FIELDS:
        np.testing.assert_allclose(got[n], ref[n], rtol=0, atol=atol, err_msg=f"{what} {n}")


@pytest.fixture(scope="module")
def batch():
    """(cfg, state0 stacked, bundles [frame][sequence]) of the small batch."""
    from uvio_tpu_torch.eval.capture import capture_batch

    torch.backends.cudnn.allow_tf32 = False
    return capture_batch(SEEDS, n_warm=WARM, n_bench=N_FRAMES, max_slam=MAX_SLAM, dtype="float64",
                         device="cpu")


def _plans(state0, bundles):
    times, plans = [float(t) for t in state0["time"]], []
    for bs in bundles:
        plans.append(plan_batch(bs, times))
        times = [float(b["stamp_time"]) for b in bs]
    return plans


def _differs(bits):
    return bool((bits != bits[:1]).any())


def _with_zupt(cfg, state0, bundles):
    """The batch with ZUPT on and one sequence (1) at rest trying it on
    frame 0: zero velocity and a stationary IMU window of its own."""
    from uvio_tpu.math import quat_to_rot

    state0 = {n: v.copy() for n, v in state0.items()}
    state0["v"][1] = state0["v_fej"][1] = 0.0
    b = dict(bundles[0][1], zupt_try=np.bool_(True))
    t0, n, M = float(state0["time"][1]), 21, cfg.layout.max_imu_batch
    t = t0 + np.arange(n) * 0.005
    g = np.asarray(quat_to_rot(jnp.asarray(state0["q"][1]))) @ np.array([0.0, 0.0, cfg.gravity_mag])
    w, a = np.tile(state0["bg"][1], (n, 1)), np.tile(state0["ba"][1] + g, (n, 1))
    pad = lambda x: np.concatenate([x, np.repeat(x[-1:], M - n, axis=0)])
    b["zupt_imu_t"], b["zupt_imu_w"], b["zupt_imu_a"] = pad(t), pad(w), pad(a)
    frame0 = list(bundles[0])
    frame0[1] = b
    return dataclasses.replace(cfg, try_zupt=True), state0, [frame0] + list(bundles[1:])


@pytest.mark.parametrize("zupt", [False, True], ids=["bench", "zupt"])
def test_batched_full_step_matches_jax_vmap(batch, zupt):
    """(i) The port's batched step against `jax.vmap(full_filter_step)` on
    the same stacked inputs, frame by frame, every info equal and the
    states within 1e-9; the plans differ between the sequences."""
    from uvio_tpu.pipeline import full_filter_step as j_full

    cfg, state0, bundles = batch
    n = N_FRAMES
    if zupt:  # ZUPT on, tried by one sequence on frame 0 only
        cfg, state0, bundles = _with_zupt(cfg, state0, bundles)
        n = 2
    plans = _plans(state0, bundles[:n])
    if zupt:
        assert plans[0].zupt_try.tolist() == [False, True, False] and not plans[1].zupt_try.any()
    else:
        assert any(_differs(p.uwb_rows) for p in plans), "no frame whose UWB rows differ"
        assert any(_differs(p.slam_init) for p in plans), "no frame whose SLAM init differs"
        assert any(_differs(p.marg) for p in plans), "no frame whose marginalization differs"
    jstep = jax.jit(jax.vmap(partial(j_full, cfg=_jcfg(cfg))))
    tstep = make_batched_full_step(cfg)
    js = _jstate(state0)
    ts = state_from_numpy(state0, device="cpu", dtype=T64)
    for k in range(n):
        js, ji = jstep(js, _jbundle(bundles[k]))
        fb, plan = stack_bundles(bundles[k], plans[k], "cpu", T64)
        ts, ti = tstep(ts, fb, plan)
        _assert_infos_equal(ti, ji, f"frame {k}")
        _assert_states_close(state_to_numpy(ts), _stacked(js), 1e-9, f"frame {k}")
        if zupt and k == 0:
            assert np.asarray(ji["zupt_accepted"]).tolist() == [False, True, False]
            assert int(ti["msckf"]["num_used"][1]) == 0 and int(ti["msckf"]["num_used"][0]) > 0


@pytest.mark.parametrize("variant", ["bench", "zupt", "zupt_explicit"])
def test_batched_sequences_equal_single_steps(batch, variant):
    """(ii) Each sequence of the port's batch equals the port's single
    `full_filter_step` on that sequence alone, to 1e-12, every info equal
    (with ZUPT on, in both variants, for the first frames)."""
    cfg, state0, bundles = batch
    n = N_FRAMES
    if variant != "bench":
        cfg, state0, bundles = _with_zupt(cfg, state0, bundles)
        cfg = dataclasses.replace(cfg, zupt_explicit=variant == "zupt_explicit")
        n = 3
    bstep, sstep = make_batched_full_step(cfg), make_full_step(cfg)
    bs_state = state_from_numpy(state0, device="cpu", dtype=T64)
    B = len(SEEDS)
    singles = [state_from_numpy({k: v[b] for k, v in state0.items()}, device="cpu", dtype=T64)
               for b in range(B)]
    times = [float(t) for t in state0["time"]]
    accepted = 0
    for k in range(n):
        plan = plan_batch(bundles[k], times)
        bs_state, bi = bstep(bs_state, *stack_bundles(bundles[k], plan, "cpu", T64))
        got = state_to_numpy(bs_state)
        for b in range(B):
            singles[b], si = sstep(singles[b], bundle_from_numpy(bundles[k][b], device="cpu", dtype=T64),
                                   plan_frame(bundles[k][b], times[b]))
            one = {name: a[None] for name, a in state_to_numpy(singles[b]).items()}
            _assert_states_close({name: a[b : b + 1] for name, a in got.items()}, one, 1e-12, f"frame {k} seq {b}")
            _assert_infos_equal({**{key: bi[key][b] for key in INFO_KEYS},
                                 "msckf": {key: bi["msckf"][key][b] for key in MSCKF_KEYS}}, si,
                                f"frame {k} seq {b}")
            accepted += int(bi["zupt_accepted"][b])
        times = [float(b["stamp_time"]) for b in bundles[k]]
    assert accepted == (0 if variant == "bench" else 1)


def test_batched_fixture_replays_at_full_width():
    """(iii) The committed four-seed fixture through the batched step at
    full width, float64: every info equal to `uvio_tpu`'s vmapped replay,
    position within 1e-6 m and trace(cov) within 1e-6 relative on every
    frame and sequence (`chip_smoke.py` phase `batch` (a))."""
    torch.backends.cudnn.allow_tf32 = False
    fx = load_batched_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    assert len(set(fx.seeds.tolist())) == len(fx.seeds) == 4
    step = make_batched_full_step(cfg)
    st, staged = stage_batched_fixture(fx, device="cpu", dtype=T64)
    ref = fx.replays["f64"]
    for k, (fb, plan) in enumerate(staged):
        st, info = step(st, fb, plan)
        for key in INFO_KEYS:
            np.testing.assert_array_equal(info[key].numpy(), ref[key][k], err_msg=f"frame {k} {key}")
        for key in MSCKF_KEYS:
            np.testing.assert_array_equal(info["msckf"][key].numpy(), ref["msckf_" + key][k],
                                          err_msg=f"frame {k} msckf {key}")
        np.testing.assert_allclose(st.p.numpy(), ref["p"][k], rtol=0, atol=1e-6, err_msg=f"frame {k}")
        tr = torch.diagonal(st.cov, dim1=-2, dim2=-1).sum(-1).numpy()
        np.testing.assert_allclose(tr, ref["cov_trace"][k], rtol=1e-6, atol=0, err_msg=f"frame {k}")
    assert ref["uwb_accepted"].any() and ref["slam_inited"].any()


def test_unbatchable_step_raises_without_looping(batch, monkeypatch):
    """(iv) A step that vmap cannot batch (here a UWB update patched to
    write a batched value into a buffer that is not) raises, after one
    call of the per-sequence code: nothing falls back to stepping the
    sequences one by one."""
    from uvio_tpu_torch import pipeline

    cfg, state0, bundles = batch
    calls = []

    def unbatchable(st, *args, **kw):
        calls.append(1)
        buf = torch.zeros(3, dtype=st.p.dtype)
        buf[:] = st.p  # in place: a batched value into an unbatched buffer
        return st, {}

    monkeypatch.setattr(pipeline, "uwb_update", unbatchable)
    step = make_batched_full_step(cfg)
    plan = plan_batch(bundles[0], [float(t) for t in state0["time"]])
    assert plan.union.uwb_rows[0]
    with pytest.raises(RuntimeError, match="vmap"):
        step(state_from_numpy(state0, device="cpu", dtype=T64),
             *stack_bundles(bundles[0], plan, "cpu", T64))
    assert len(calls) == 1


def _zeros_as_before(self, size, *args, **kw):
    """`Tensor.new_zeros` as the repaired functions allocated before:
    `torch.zeros` of the tensor's dtype and device."""
    return torch.zeros(size, dtype=self.dtype, device=self.device)


def test_vmap_repairs_are_bit_identical(batch, monkeypatch):
    """(v) The functions whose buffers became `new_zeros` of a state tensor
    (the range Jacobian, the clone Jacobian with time-offset calibration,
    the ZUPT systems and bias inflation, both ZUPT variants) give states
    bit-identical to the same functions on the `torch.zeros` buffers they
    had before, and each now runs under vmap."""
    from uvio_tpu_torch.filter.ekf import augment_clone
    from uvio_tpu_torch.update import uwb, zupt

    cfg, state0, bundles = batch
    L = cfg.layout
    b = bundles[0][0]
    one = state_from_numpy({k: v[0] for k, v in state0.items()}, device="cpu", dtype=T64)
    Lt = dataclasses.replace(L, calib_cam_timeoffset=True)
    timed = state_from_numpy({k: v[0] for k, v in state0.items()} | {"cov": np.eye(Lt.dim) * 1e-3},
                             device="cpu", dtype=T64)
    t = lambda name: torch.as_tensor(b[name])
    imu = (t("imu_t"), t("imu_w"), t("imu_a"))
    zkw = dict(stamp_time=t("stamp_time"))
    calls = {  # name -> (input state, function of a state)
        "uwb_update": (one, lambda s: uwb.uwb_update(s, L, t("uwb_ranges")[0], t("uwb_mask")[0],
                                                     sigma_range=cfg.sigma_range)[0]),
        "augment_clone": (timed, lambda s: augment_clone(s, Lt, torch.tensor([0.1, -0.2, 0.3], dtype=T64))),
        "zupt_try_update": (one, lambda s: zupt.zupt_try_update(s, L, *imu, cfg.noises, cfg.gravity_mag,
                                                                **zkw)[0]),
        "zupt_explicit_update": (one, lambda s: zupt.zupt_explicit_update(s, L, *imu, cfg.noises,
                                                                          cfg.gravity_mag, **zkw)[0]),
    }
    B = 3
    for name, (st, call) in calls.items():
        now = call(st)
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "new_zeros", _zeros_as_before)
            before = call(st)
        for n in FIELDS:
            assert torch.equal(getattr(now, n), getattr(before, n)), f"{name} {n}"
        fields = tuple(torch.stack([getattr(st, n)] * B) for n in FIELDS)
        out = torch.func.vmap(lambda f: tuple(getattr(call(FilterState(**dict(zip(FIELDS, f)))), n)
                                              for n in FIELDS))(fields)
        for n, x in zip(FIELDS, out):
            for r in range(B):
                torch.testing.assert_close(x[r], getattr(now, n), rtol=0, atol=1e-12, msg=f"{name} {n}")

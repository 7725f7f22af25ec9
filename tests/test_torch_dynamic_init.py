"""Port parity, the in-motion initializer (`init/dynamic_init.py` and
`VioManager._try_dynamic_init`), float64 on the CPU.

Tolerances:
  * `solve_dynamic_init` on `tests/test_dynamic_init.py`'s window (seed 5,
    the aggressive lap, noisy IMU and pixels, 8 features): params,
    `rmse_norm` and `rcond` within 1e-8 relative of `uvio_tpu`'s, and the
    same sequence of accepted and rejected Gauss-Newton steps (`uvio_tpu`
    returns no such sequence: it is read off its solves cut after
    1, 2, ... steps, a step being taken where the parameters move);
  * `result_to_state_first` / `result_to_state` on the same solution:
    1e-10;
  * both packages' `UVioManager` (and, slow, `VioManager`) with
    `use_dynamic_init=True`, fed the same simulator events in motion from
    the first sample: they attempt and initialise on the same frame with
    the same slot times and the same state to 1e-8, and stay equal frame
    by frame after it.
The slow twin runs `test_dynamic_init_end_to_end`'s scenario through the
port under its gates (init < 5 s after start, posyaw ATE < 0.25 m).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uvio_tpu.init import dynamic_init as JD
from uvio_tpu.sim import SimParams as JSimParams
from uvio_tpu.sim import Simulator as JSimulator
from uvio_tpu.sim import circle_trajectory as j_circle

from uvio_tpu_torch.init import dynamic_init as TD

from test_dynamic_init import make_window
from test_torch_manager import make_pair, sim_events

torch.set_num_threads(1)

FIELDS = ("v0", "g", "bg", "ba", "feats")


@pytest.fixture(scope="module")
def window():
    sim = JSimulator(JSimParams(seed=5), trajectory=j_circle(duration=14.0, lap_s=8.0))
    (imu_t, imu_w, imu_a), (obs, mask), (R_ItoC, p_IinC), _ = make_window(sim, f_max=8, noise=True)
    return imu_t, imu_w, imu_a, obs, mask, R_ItoC, p_IinC


def _j_solve(window, **opts):
    return JD.solve_dynamic_init(*[jnp.asarray(x) for x in window], JD.DynamicInitOptions(**opts))


def _t_solve(window, **opts):
    return TD.solve_dynamic_init(*[torch.as_tensor(np.array(x)) for x in window], TD.DynamicInitOptions(**opts))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# the default seeds converge in 3 steps; seeds far off the answer (0.87
# rad/s and 3.5 m/s^2 of bias) make the first step overshoot and be
# rejected
CASES = {
    "default": dict(gn_iters=3),
    "cpi_v1": dict(gn_iters=3, cpi_model="cpi_v1"),
    "far_seeds": dict(gn_iters=2, init_bias_g=np.array([0.5, 0.5, -0.5]),
                      init_bias_a=np.array([2.0, 2.0, 2.0])),
}


@pytest.fixture(scope="module")
def solved(window):
    """uvio_tpu's solve of each case, once."""
    return {case: _j_solve(window, **opts) for case, opts in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches(window, solved, case):
    opts = CASES[case]
    j, t = solved[case], _t_solve(window, **opts)
    for k in FIELDS:
        assert _rel(t["params"][k].numpy(), j["params"][k]) < 1e-8, k
    assert _rel(t["rmse_norm"].numpy(), j["rmse_norm"]) < 1e-8
    assert _rel(t["rcond"].numpy(), j["rcond"]) < 1e-8
    assert float(t["n_obs"]) == float(j["n_obs"]) == 48.0
    np.testing.assert_allclose(t["hessian"].numpy(), np.asarray(j["hessian"]), rtol=1e-8, atol=1e-6)
    accepted = t["accepted"].tolist()
    assert len(accepted) == opts["gn_iters"]
    if case != "far_seeds":
        assert all(accepted) and float(t["rmse_norm"]) < 5e-3
        return
    assert accepted == [False, True]
    # uvio_tpu's sequence: step k was taken where its solve cut after k
    # steps has moved from its solve cut after k - 1
    xs = [_j_solve(window, **{**opts, "gn_iters": k})["params"] for k in range(opts["gn_iters"])]
    xs.append(j["params"])
    flat = [np.concatenate([np.ravel(x[f]) for f in FIELDS]) for x in xs]
    assert [bool(np.any(b != a)) for a, b in zip(flat, flat[1:])] == accepted


def test_result_to_state_matches(window, solved):
    jp = {k: np.array(v) for k, v in solved["default"]["params"].items()}
    tp = {k: torch.as_tensor(v) for k, v in jp.items()}
    opts = JD.DynamicInitOptions()
    a, b = JD.result_to_state_first(jp, opts), TD.result_to_state_first(tp, TD.DynamicInitOptions())
    for k in ("q_GtoI", "p", "v", "bg", "ba"):
        np.testing.assert_allclose(b[k], np.asarray(a[k]), rtol=0, atol=1e-10, err_msg=k)
    imu = window[:3]
    a = JD.result_to_state({k: jnp.asarray(v) for k, v in jp.items()}, *[jnp.asarray(x) for x in imu], opts)
    b = TD.result_to_state(tp, *[torch.as_tensor(np.array(x)) for x in imu], TD.DynamicInitOptions())
    assert a["time"] == b["time"]
    for k in ("q_GtoI", "p", "v", "bg", "ba"):
        np.testing.assert_allclose(b[k], np.asarray(a[k]), rtol=0, atol=1e-10, err_msg=k)


# `UVioManager` runs the inherited method and the UWB buffer, so tier-1
# runs it alone; the `VioManager` twin is slow
@pytest.mark.parametrize("manager", [pytest.param("VioManager", marks=pytest.mark.slow), "UVioManager"])
def test_managers_initialise_in_motion_alike(monkeypatch, manager):
    """Moving from the first sample (aggressive lap): static init never
    fires, the dynamic one does, on the same frame in both packages,
    after the same solver attempts (both reject the first three on the
    accelerometer-bias gate). Reduced: 8 tracks, 3 Gauss-Newton steps.
    `uvio_tpu`'s solver runs under one `jax.jit` for all attempts (run
    op by op it compiles its loops again at every attempt; the two agree
    to ~1e-12). `UVioManager` inherits the method: ranges arrive from the
    start, none is buffered before the init, and the buffers stay equal
    after it."""
    import jax

    import uvio_tpu.init.dynamic_init as j_mod
    from uvio_tpu.uwb_manager import AnchorConfig as JAnchor
    from uvio_tpu.uwb_manager import UVioConfig as JUVioConfig
    from uvio_tpu.uwb_manager import UVioManager as JUVioManager

    import uvio_tpu_torch.manager as t_mod
    from uvio_tpu_torch.uwb_manager import AnchorConfig, UVioConfig, UVioManager

    from test_torch_uwb_manager import ANCHORS, _anchor_cfgs

    uwb = manager == "UVioManager"
    sim, events = sim_events(26, seed=3, num_pts=60, lap_s=8.0, uwb_anchors=ANCHORS if uwb else None)
    dyn = dict(max_features=8, gn_iters=3)
    jx, tx, kw = dict(dyn_init_options=JD.DynamicInitOptions(**dyn)), dict(dyn_init_options=TD.DynamicInitOptions(**dyn)), {}
    if uwb:
        jx["anchors"], tx["anchors"] = _anchor_cfgs(JAnchor), _anchor_cfgs(AnchorConfig)
        kw = dict(jcls=JUVioManager, tcls=UVioManager, jconfig=JUVioConfig, tconfig=UVioConfig,
                  max_anchors=4, sigma_range=sim.params.sigma_range)
    pair = make_pair(sim, use_static_init=True, use_dynamic_init=True, jextra=jx, textra=tx, **kw)
    solves = {"j": [], "t": []}
    j_jit = jax.jit(j_mod.solve_dynamic_init, static_argnums=7)
    j_solve = lambda *args: j_jit(*args[:7], _Hashed(args[7]))
    for name, mod, solve in (("j", j_mod, j_solve), ("t", t_mod, t_mod.solve_dynamic_init)):
        def counted(*args, inner=solve, name=name):
            out = inner(*args)
            solves[name].append((float(out["rmse_norm"]), float(out["rcond"])))
            return out

        monkeypatch.setattr(mod, "solve_dynamic_init", counted)
    init_frame, frame = None, 0
    for ev in events:
        pair.feed(ev)  # states, slot times and host mirrors compared after every frame
        if ev[0] != "cam":
            continue
        frame += 1
        assert len(solves["j"]) == len(solves["t"]), frame
        if pair.t.is_initialized and init_frame is None:
            init_frame = frame
            assert pair.j.is_initialized
            assert len(pair.t.slot_times) == pair.t.cfg.max_clones  # the replayed window
        if uwb:
            assert pair.t.uwb_buffer == pair.j.uwb_buffer and pair.t._last_uwb_t == pair.j._last_uwb_t
            assert pair.t.is_initialized or not pair.t.uwb_buffer
    assert init_frame == 19 and len(solves["t"]) == 4, (init_frame, solves)
    np.testing.assert_allclose(solves["t"], solves["j"], rtol=1e-8)
    assert pair.checked == frame - init_frame  # the frames after it ran the full step in both
    if uwb:
        assert sum(int(np.asarray(b["uwb_mask"]).sum()) for b in pair.tb) > 0  # ranges were used after it


class _Hashed:
    """Options as a static `jax.jit` argument, hashed by the identity of
    the options object (the dataclass holds arrays); attribute reads go
    to the options."""

    def __init__(self, opts):
        self._opts = opts

    def __getattr__(self, name):
        return getattr(self._opts, name)

    def __hash__(self):
        return id(self._opts)

    def __eq__(self, other):
        return isinstance(other, _Hashed) and other._opts is self._opts


@pytest.mark.slow
def test_dynamic_init_end_to_end_port():
    """`tests/test_dynamic_init.py::test_dynamic_init_end_to_end` through
    the port: dynamic init fires < 5 s after start, the window replays
    and the filter tracks for 12 s (posyaw ATE < 0.25 m)."""
    from uvio_tpu_torch.eval import ate
    from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(seed=11), trajectory=circle_trajectory(duration=24.0, lap_s=8.0))
    cam = sim.params.cameras[0]
    mgr = VioManager(VioConfig(
        max_clones=11, sigma_pix=1.0, use_static_init=True, use_dynamic_init=True, max_slam=15,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC,
                              p_IinC=cam.p_IinC)],
        device="cpu",
    ))
    est, gts = {"t": [], "q": [], "p": []}, {"q": [], "p": []}
    init_t, tc = None, 0.0
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        mgr.feed_imu(*r)
        if sim.cur_cam_t + 0.1 <= r[0]:
            rc = sim.get_next_cam()
            if rc is None:
                break
            tc, obs = rc
            mgr.feed_features(tc, obs)
            if mgr.is_initialized:
                init_t = tc if init_t is None else init_t
                q, p = mgr.get_pose()
                est["t"].append(tc)
                est["q"].append(q)
                est["p"].append(p)
                g = sim.get_gt_state(tc)
                gts["q"].append(g["q_GtoI"])
                gts["p"].append(g["p_IinG"])
        if init_t and tc - init_t > 12:
            break
    assert init_t is not None, "dynamic init never fired"
    assert init_t - sim.t_start < 5.0
    res = ate(np.asarray(est["t"]), np.asarray(est["q"]), np.asarray(est["p"]),
              np.asarray(est["t"]), np.asarray(gts["q"]), np.asarray(gts["p"]), method="posyaw")
    assert res["rmse_pos"] < 0.25, res["rmse_pos"]

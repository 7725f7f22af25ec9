"""Port parity, SLAM: the six landmark representations, the anchor change,
`slam_update` / `slam_delayed_init`, `marginalize_slam` and the invertible
block initialization, in float64 on the CPU.

States come from the committed replay fixture (the `bench.py` scenario):
its float64 states before frames 3 (one landmark, 8 candidates to
initialize) and 16 (all 25 slots full), with the landmarks re-expressed
in the representation under test through `uvio_tpu`'s own maps.

Tolerances: the representation maps and the anchor change are the same
closed forms in both packages, so they agree to rounding (1e-10); the
port's closed-form d(sphere)/d(point) against JAX's autodiff too. The
SLAM updates go through QR factorizations whose bases differ between
LAPACK builds by signs and rotations; the invariants compared are the
gate decisions (exactly) and the updated state and covariance (1e-8).
"""

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvio_tpu.types.state import FilterState as JState
from uvio_tpu.update import representations as JR

from uvio_tpu_torch.fixtures import load_full_step_fixture
from uvio_tpu_torch.pipeline import FullStepConfig, bundle_from_numpy
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import representations as TR

torch.set_num_threads(1)

T64 = torch.float64


@pytest.fixture(scope="module")
def fx():
    return load_full_step_fixture()


def _t(a):
    return torch.as_tensor(np.array(a), dtype=T64)


def _jstate(arrays):
    return JState(**{n: jnp.asarray(arrays[n]) for n in FIELDS})


def _np(js):
    return {n: np.asarray(getattr(js, n)) for n in FIELDS}


def _close(a, b, atol, msg=""):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=atol, err_msg=msg)


def _random_values(rep, n=32, seed=0):
    """Representation values in the maps' regular domain."""
    rng = np.random.default_rng(seed)
    if rep in (TR.GLOBAL_3D, TR.ANCHORED_3D):
        return np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(1, 10, n)], 1)
    if rep in (TR.GLOBAL_FULL_INVERSE_DEPTH, TR.ANCHORED_FULL_INVERSE_DEPTH):
        return np.stack([rng.uniform(-3.0, 3.0, n), rng.uniform(0.3, 2.8, n), rng.uniform(0.1, 1.0, n)], 1)
    return np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n), rng.uniform(0.1, 1.0, n)], 1)


def _maps(m, rep):
    """(value -> point, point -> value, d point/d value, d value/d point)
    of representation `rep` in module `m` (JAX: one value at a time)."""
    if TR.is_anchored(rep):
        return (partial(m.anchor_point_from_value, rep), partial(m.value_from_anchor_point, rep),
                partial(m.d_anchor_point_d_value, rep), partial(m.d_value_d_anchor_point, rep))
    d_val = m.d_sphere_d_point if m is TR else jax.jacfwd(JR.point_to_sphere)
    return m.sphere_to_point, m.point_to_sphere, m.d_point_d_sphere, d_val


@pytest.mark.parametrize("rep", range(1, 6))  # GLOBAL_3D's maps are the identity
def test_representation_maps_match(rep):
    vals = _random_values(rep, seed=rep)
    jmaps = [jax.vmap(f) for f in _maps(JR, rep)]
    to_pt, to_val, d_pt, d_val = _maps(TR, rep)
    pts = np.asarray(jmaps[0](jnp.asarray(vals)))
    _close(pts, to_pt(_t(vals)), 1e-10, "value -> point")
    _close(vals, to_val(_t(pts)), 1e-10, "round trip")
    _close(jmaps[1](jnp.asarray(pts)), to_val(_t(pts)), 1e-10, "point -> value")
    Jp, Jv = d_pt(_t(vals)), d_val(_t(pts))
    _close(jmaps[2](jnp.asarray(vals)), Jp, 1e-10, "d point / d value")
    _close(jmaps[3](jnp.asarray(pts)), Jv, 1e-10, "d value / d point")
    # against torch's autodiff of the port's own maps; the 1-dof rep's
    # Jacobians are the full ones with the bearing dofs masked out
    ad_p = torch.func.vmap(torch.func.jacfwd(to_pt))(_t(vals))
    ad_v = torch.func.vmap(torch.func.jacfwd(to_val))(_t(pts))
    if rep == TR.ANCHORED_INVERSE_DEPTH_SINGLE:
        rho = torch.tensor([0.0, 0.0, 1.0], dtype=T64)
        ad_p, ad_v = ad_p * rho, ad_v * rho[:, None]
    _close(ad_p, Jp, 1e-10, "jacfwd d point / d value")
    _close(ad_v, Jv, 1e-10, "jacfwd d value / d point")


@pytest.mark.parametrize("rep", range(6))
def test_landmark_chain_matches(fx, rep):
    """landmark_global (value and FEJ), anchored_chain and point_to_rep on
    the fixture's 25 landmarks, re-expressed in `rep`."""
    L, arrays = _state_in_rep(fx, 16, rep)
    js, ts, tl = _jstate(arrays), state_from_numpy(arrays, device="cpu", dtype=T64), _tlayout(fx.config, rep)
    for fej in (False, True):
        for a, b in zip(JR.landmark_global(js, L, fej=fej), TR.landmark_global(ts, tl, fej=fej)):
            _close(a, b, 1e-10, f"landmark_global fej={fej}")
    for i, (a, b) in enumerate(zip(JR.anchored_chain(js, L), TR.anchored_chain(ts, tl))):
        _close(a, b, 1e-10, f"anchored_chain[{i}]")
    p_glob = np.asarray(JR.landmark_global(js, L)[0])
    slot, cam = int(arrays["clone_head"]), 0
    _close(jax.vmap(lambda p: JR.point_to_rep(js, L, p, jnp.int32(slot), jnp.int32(cam)))(jnp.asarray(p_glob)),
           TR.point_to_rep(ts, tl, _t(p_glob), torch.tensor(slot), torch.tensor(cam)), 1e-10, "point_to_rep")


def _state_in_rep(fx, frame, rep, anchor_slots=None):
    """The fixture's float64 state before `frame`, its landmarks
    re-expressed in `rep` (optionally re-anchored) with `uvio_tpu`'s maps;
    the FEJ value is kept 1e-3 off the value so FEJ paths are exercised.
    For GLOBAL_3D the covariance follows the change of variables
    (P' = T P T^T, T's landmark rows = d p_FinG / d(value, anchor pose)),
    so that its gates see a consistent covariance."""
    cfg = fx.config
    arrays = dict(fx.snapshots[frame])
    L1 = _layout(cfg, 1)  # the fixture's landmarks are anchored inverse depth
    js = _jstate(arrays)
    p_glob, _ = JR.landmark_global(js, L1)
    p_fej, _ = JR.landmark_global(js, L1, fej=True)
    if anchor_slots is not None:
        arrays["slam_anchor_slot"] = np.asarray(anchor_slots, np.int32)
        js = _jstate(arrays)
    L = _layout(cfg, rep)
    slots, cams = js.slam_anchor_slot, js.slam_anchor_cam
    conv = jax.vmap(lambda p, s, c: JR.point_to_rep(js, L, p, s, c))
    valid = arrays["slam_valid"][:, None]
    arrays["slam_p"] = np.where(valid, np.asarray(conv(p_glob, slots, cams)), 0.0)
    arrays["slam_p_fej"] = np.where(valid, np.asarray(conv(p_fej + 1e-3, slots, cams)), 0.0)
    if rep == TR.GLOBAL_3D:
        _, _, J_rep, H_anc = (np.asarray(x) for x in JR.anchored_chain(js, L1))
        T = np.eye(L.dim)
        for s in np.nonzero(arrays["slam_valid"])[0]:
            r = L.slam_slot_off(s)
            c = L.clone_slot_off(int(arrays["slam_anchor_slot"][s]))
            T[r : r + 3, r : r + 3] = J_rep[s]
            T[r : r + 3, c : c + 6] = H_anc[s]
        arrays["cov"] = T @ arrays["cov"] @ T.T
    return L, arrays


def _layout(cfg, rep):
    from uvio_tpu.types import StateLayout

    return StateLayout(**{**cfg["layout"], "slam_rep": rep})


def _tlayout(cfg, rep):
    from uvio_tpu_torch.types import StateLayout

    return StateLayout(**{**cfg["layout"], "slam_rep": rep})


@pytest.mark.parametrize("rep", [1, 2, 4, 5])
def test_anchor_change_matches(fx, rep):
    frame = 16
    marg = int(fx.bundles[frame]["marg_slot"])
    snap = fx.snapshots[frame]
    new = int(snap["clone_head"])
    # every other landmark anchored at the clone being marginalized
    anchors = np.where(np.arange(25) % 2 == 0, marg, snap["slam_anchor_slot"])
    L, arrays = _state_in_rep(fx, frame, rep, anchors)
    js = _jstate(arrays)
    jout = JR.anchor_change(js, L, jnp.int32(marg), jnp.int32(new))
    ts = state_from_numpy(arrays, device="cpu", dtype=T64)
    tout = TR.anchor_change(ts, _tlayout(fx.config, rep), torch.tensor(marg), torch.tensor(new))
    moved = arrays["slam_valid"] & (anchors == marg)
    assert moved.sum() >= 10
    assert (state_to_numpy(tout)["slam_anchor_slot"][moved] == new).all()
    for n in ("slam_p", "slam_p_fej", "slam_anchor_slot", "cov"):
        _close(getattr(jout, n), getattr(tout, n), 1e-10, n)
    assert np.abs(np.asarray(jout.cov) - arrays["cov"]).max() > 1e-6  # the covariance moved


def _pre_slam_state(fx, frame, rep):
    """The state the SLAM updates see on `frame` (after the UWB drain,
    propagate+clone and the MSCKF update), from the port's own float64
    step: both packages then start from the same numpy state."""
    from uvio_tpu_torch.filter.propagator import propagate_and_clone
    from uvio_tpu_torch.pipeline import _uwb_drain, plan_frame
    from uvio_tpu_torch.update.msckf import msckf_update

    L, arrays = _state_in_rep(fx, frame, rep)
    tl = _tlayout(fx.config, rep)
    cfg = dataclasses.replace(FullStepConfig.from_dict(fx.config), layout=tl)
    b = fx.bundles[frame]
    fb = bundle_from_numpy(b, device="cpu", dtype=T64)
    st, _, _ = _uwb_drain(state_from_numpy(arrays, device="cpu", dtype=T64), fb, plan_frame(b, arrays["time"]), cfg)
    st = propagate_and_clone(st, tl, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises, cfg.gravity_mag,
                             stamp_time=fb.stamp_time)
    st, _ = msckf_update(st, tl, cfg.cam_model, fb.msckf_uv, fb.msckf_mask, sigma_pix=cfg.sigma_pix)
    return L, tl, state_to_numpy(st), fb, cfg


@functools.lru_cache(maxsize=None)
def _jit(name, L, cam_model, sigma_pix):
    """uvio_tpu's slam_update / slam_delayed_init, jitted once per layout."""
    from uvio_tpu.update.slam import slam_delayed_init, slam_update

    fn = slam_update if name == "update" else slam_delayed_init
    return jax.jit(partial(fn, layout=L, cam_model=cam_model, sigma_pix=sigma_pix))


@pytest.mark.parametrize("rep", [0, 1])
@pytest.mark.parametrize("frame", [3, 16])  # one landmark and 8 candidates / all 25 slots full
def test_slam_update_and_init_match(fx, frame, rep):
    from uvio_tpu_torch.update.slam import slam_delayed_init, slam_update

    L, tl, arrays, fb, cfg = _pre_slam_state(fx, frame, rep)
    b = fx.bundles[frame]
    js = _jstate(arrays)
    ju, jui = _jit("update", L, cfg.cam_model, cfg.sigma_pix)(
        js, obs_uv=jnp.asarray(b["slam_uv"]), obs_mask=jnp.asarray(b["slam_mask"]))
    tu, tui = slam_update(state_from_numpy(arrays, device="cpu", dtype=T64), tl, fb.slam_uv, fb.slam_mask,
                          cfg.cam_model, sigma_pix=cfg.sigma_pix)
    for k in ("kept", "failed", "cov_ok"):
        np.testing.assert_array_equal(tui[k].numpy(), np.asarray(jui[k]), err_msg=k)
    if frame == 16:
        assert tui["kept"].sum() >= 5
    for n in ("q", "p", "v", "clones_q", "clones_p", "slam_p", "anchors_p", "cov"):
        _close(getattr(ju, n), getattr(tu, n), 1e-8, n)

    # delayed init from the same (JAX-updated) state in both packages
    after = _np(ju)
    ji, jii = _jit("init", L, cfg.cam_model, cfg.sigma_pix)(
        _jstate(after), obs_uv=jnp.asarray(b["cand_uv"]), obs_mask=jnp.asarray(b["cand_mask"]),
        target_slots=jnp.asarray(b["cand_slots"]), cand_ids=jnp.asarray(b["cand_ids"]))
    ti, tii = slam_delayed_init(state_from_numpy(after, device="cpu", dtype=T64), tl, fb.cand_uv, fb.cand_mask,
                                fb.cand_slots, fb.cand_ids, cfg.cam_model, sigma_pix=cfg.sigma_pix)
    np.testing.assert_array_equal(tii["inited"].numpy(), np.asarray(jii["inited"]))
    if frame == 3 and rep == 1:  # GLOBAL_3D's stricter baseline gate takes none
        assert tii["inited"].sum() >= 1
    back = state_to_numpy(ti)
    for n in ("slam_valid", "slam_id", "slam_anchor_slot", "slam_anchor_cam"):
        np.testing.assert_array_equal(back[n], np.asarray(getattr(ji, n)), err_msg=n)
    for n in ("q", "p", "clones_p", "slam_p", "slam_p_fej", "cov"):
        _close(getattr(ji, n), getattr(ti, n), 1e-8, n)


def test_marginalize_slam_and_block_init_match():
    from uvio_tpu.filter import ekf as JE
    from uvio_tpu.types import StateLayout as JL
    from uvio_tpu.types import init_state

    from uvio_tpu_torch.filter import ekf as TE
    from uvio_tpu_torch.types import StateLayout as TL

    kw = dict(max_clones=4, max_slam=3, max_anchors=1)
    L = JL(**kw)
    rng = np.random.default_rng(7)
    D = L.dim
    A = rng.normal(size=(D, D)) * 0.1
    cov = A @ A.T + 1e-3 * np.eye(D)
    js = init_state(L).replace(cov=jnp.asarray(cov), slam_valid=jnp.ones(3, bool),
                               slam_id=jnp.asarray([4, 5, 6], jnp.int32))
    arrays = _np(js)
    jm = JE.marginalize_slam(js, L, jnp.int32(1))
    tm = TE.marginalize_slam(state_from_numpy(arrays, device="cpu", dtype=T64), TL(**kw), torch.tensor(1))
    back = state_to_numpy(tm)
    for n in ("slam_valid", "slam_id", "cov"):
        np.testing.assert_array_equal(back[n], np.asarray(getattr(jm, n)), err_msg=n)

    H_R = rng.normal(size=(3, D))
    H_L = np.triu(rng.normal(size=(3, 3))) + 2 * np.eye(3)
    rd = rng.uniform(0.5, 2.0, 3)
    res = rng.normal(size=3)
    off = L.slam_slot_off(2)
    jc, jdx = JE.initialize_invertible_block(jnp.asarray(cov), jnp.int32(off), *map(jnp.asarray, (H_R, H_L, rd, res)))
    tc, tdx = TE.initialize_invertible_block(_t(cov), torch.tensor(off), _t(H_R), _t(H_L), _t(rd), _t(res))
    _close(jc, tc, 1e-10, "cov")
    _close(jdx, tdx, 1e-10, "dx")

    block = np.diag([0.1, 0.2, 0.3])
    _close(JE.set_block_covariance(jnp.asarray(cov), jnp.int32(off), block),
           TE.set_block_covariance(_t(cov), off, block), 0.0)
    blocks = [(L.slam_slot_off(2), 3), (0, 6)]
    _close(JE.get_marginal_covariance(jnp.asarray(cov), blocks), TE.get_marginal_covariance(_t(cov), blocks), 0.0)


@pytest.mark.parametrize("rep", [1, 2, 4, 5])
def test_anchor_change_int_slot_is_bit_equal(fx, rep):
    """`marg_slot` as a Python int (the manager's path, no index upload)
    gives the tensor path's state bit for bit."""
    frame = 16
    marg = int(fx.bundles[frame]["marg_slot"])
    snap = fx.snapshots[frame]
    anchors = np.where(np.arange(25) % 2 == 0, marg, snap["slam_anchor_slot"])
    _, arrays = _state_in_rep(fx, frame, rep, anchors)
    ts = state_from_numpy(arrays, device="cpu", dtype=T64)
    tl = _tlayout(fx.config, rep)
    new = torch.tensor(int(snap["clone_head"]))
    a = state_to_numpy(TR.anchor_change(ts, tl, torch.tensor(marg), new))
    b = state_to_numpy(TR.anchor_change(ts, tl, marg, new))
    for n in FIELDS:
        np.testing.assert_array_equal(b[n], a[n], err_msg=n)
    assert (b["slam_anchor_slot"][arrays["slam_valid"] & (anchors == marg)] == int(new)).all()

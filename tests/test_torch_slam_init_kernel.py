"""The SLAM delayed-init kernel's plumbing on the CPU (`update/slam.py`,
the launch of `csrc/slam_init.cu`).

The kernel runs only on the card (`tests/test_torch_slam_init_kernel_cuda.py`).
What surrounds it is checked here, where a silent fault would hide:

  * CPU tensors run `slam_delayed_init_ref`, bitwise, and launch nothing;
  * the whole launch path (routing, the launch's batch rule under
    `torch.func.vmap`, the pointer and int arrays, the outputs mapped back
    to the state) with the C entry point replaced by a NumPy model of it
    that reads the arrays as the kernel does: the Householder split, then
    the sequential gate, block init and update. It holds the plain
    version to 1e-10 of each field's largest magnitude in float64 (the
    split is three reflections where the plain version forms a complete
    Q, and the sums run in another order) and 1e-4 in float32, with equal
    `inited`, and counts one launch a call, batched or not;
  * a candidate that fails its gate, an inactive candidate, one whose
    init block is singular and one whose H_f is not finite each change
    nothing;
  * a candidate's H_x lies in the camera calibration and clone columns,
    the most live columns the kernel's shared memory holds.

States: the committed replay fixture's frame 3 (8 candidates, the
bench scenario's layout, D 182) and states on the EuRoC cell's layout
(12 clone slots, 50 landmark slots, one camera with its extrinsics,
intrinsics and time offset calibrated: D 252) and on its stereo layout
(two cameras: D 266, 48 rows a candidate) whose candidates are
projections of points 4-7 m ahead, with pixel noise, one outlier track
and one inactive row; each in the six landmark representations.

Imports neither JAX nor `uvio_tpu`.
"""

import dataclasses
import types

import kernel_model as km
import numpy as np
import pytest
import torch

from uvio_tpu_torch import launches
from uvio_tpu_torch.cam import models as cam_models
from uvio_tpu_torch.filter.ekf import MASKS
from uvio_tpu_torch.filter.propagator import propagate_and_clone
from uvio_tpu_torch.fixtures import load_full_step_fixture
from uvio_tpu_torch.pipeline import FullStepConfig, _uwb_drain, bundle_from_numpy, plan_frame
from uvio_tpu_torch.types.layout import StateLayout
from uvio_tpu_torch.types.state import FIELDS, FilterState, init_state, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import slam
from uvio_tpu_torch.update.msckf import msckf_update
from uvio_tpu_torch.update.representations import ANCHORED_INVERSE_DEPTH_SINGLE

T64 = torch.float64
REPS = range(6)
CELL = dict(max_clones=12, max_slam=50, num_cams=1, calib_cam_timeoffset=True, calib_cam_pose=True,
            calib_cam_intrinsics=True)


# ---------------------------------------------------------------------------
# the states
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Case:
    layout: StateLayout
    state: FilterState
    uv: torch.Tensor  # (Fc,K,C,2)
    mask: torch.Tensor  # (Fc,K,C)
    slots: torch.Tensor  # (Fc,)
    ids: torch.Tensor  # (Fc,)
    cam_model: int
    sigma_pix: float = 1.0

    def args(self):
        return (self.state, self.layout, self.uv, self.mask, self.slots, self.ids, self.cam_model)

    def to(self, dtype):
        arrays = state_to_numpy(self.state)
        return dataclasses.replace(self, state=state_from_numpy(arrays, "cpu", dtype))


def fixture_case(rep, frame=3):
    """The fixture's float64 state on `frame` after the UWB drain,
    propagate+clone and the MSCKF update, with the frame's 8 candidates,
    the layout's landmarks read as `rep` (the delayed init does not read
    the landmarks in the state)."""
    fx = load_full_step_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    arrays, b = fx.snapshots[frame], fx.bundles[frame]
    fb = bundle_from_numpy(b, device="cpu", dtype=T64)
    L0 = cfg.layout
    st, _, _ = _uwb_drain(state_from_numpy(arrays, "cpu", T64), fb, plan_frame(b, arrays["time"]), cfg)
    st = propagate_and_clone(st, L0, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises, cfg.gravity_mag,
                             stamp_time=fb.stamp_time)
    st, _ = msckf_update(st, L0, cfg.cam_model, fb.msckf_uv, fb.msckf_mask, sigma_pix=cfg.sigma_pix)
    return Case(dataclasses.replace(L0, slam_rep=rep), st, fb.cand_uv, fb.cand_mask, fb.cand_slots, fb.cand_ids,
                cfg.cam_model, cfg.sigma_pix)


def _quat_from_rotvec(v):
    """JPL quaternion (x, y, z, w), w >= 0, of the rotation vector v."""
    th = np.linalg.norm(v)
    axis = v / th if th > 0 else np.zeros(3)
    return np.array([*(np.sin(th / 2) * axis), np.cos(th / 2)])


def cell_case(rep, seed=0, dtype=T64, cams=1):
    """A state on the EuRoC cell's layout (`cams` 2: its stereo layout): 12
    clones 8 cm apart on a gently turning path (JPL R_GtoI), camera 0 a few
    cm and degrees off the IMU with radtan intrinsics of 752x480, camera 1
    11 cm to its right; 8 candidates at points 4-7 m ahead, seen from
    every clone and camera with 0.4 px noise; candidate 2 has one
    observation 75 px off (its gate fails), candidate 5 is an inactive row
    (id -1), candidate 6 is seen twice only, by camera 0 (too few rows); a dense SPD
    covariance of a few cm and mrad."""
    rng = np.random.default_rng(seed)
    L = StateLayout(**dict(CELL, num_cams=cams), slam_rep=rep)
    K, S, D = L.max_clones, L.max_slam, L.dim
    a = state_to_numpy(init_state(L, device="cpu"))
    qs = [_quat_from_rotvec(np.array([0.01 * k, 0.02 * k, 0.005 * k])) for k in range(K)]
    ps = [np.array([0.08 * k, 0.01 * np.sin(k), 0.02 * k]) for k in range(K)]
    intr = np.array([458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    q_ItoC = np.stack([_quat_from_rotvec(np.array([0.01, -0.02, 0.015])),
                       _quat_from_rotvec(np.array([-0.005, 0.01, 0.02]))])[:cams]
    p_IinC = np.array([[0.05, -0.03, 0.01], [-0.06, -0.028, 0.012]])[:cams]
    a.update(clones_q=np.stack(qs), clones_p=np.stack(ps), clones_q_fej=np.stack(qs), clones_p_fej=np.stack(ps),
             clones_valid=np.ones(K, bool), clones_t=np.arange(K) * 0.05, clone_head=np.array(K - 1),
             q=qs[-1], p=ps[-1], time=np.array((K - 1) * 0.05),
             calib_cam_q=q_ItoC, calib_cam_p=p_IinC, calib_cam_intr=np.stack([intr] * cams))
    # two landmarks in the state already, in slots 0 and 3
    a["slam_valid"][[0, 3]] = True
    a["slam_id"][[0, 3]] = [900, 901]
    a["slam_p"][[0, 3]] = rng.normal(size=(2, 3))
    Mx = rng.normal(size=(D, D)) * 0.0006
    cov = Mx @ Mx.T + np.diag(np.full(D, 4e-6))
    free = [s for s in range(S) if not a["slam_valid"][s]]
    for s in free:  # the free slots' rows and columns are zero
        r = L.slam_off + 3 * s
        cov[r:r + 3, :] = 0
        cov[:, r:r + 3] = 0
    a["cov"] = cov
    st = state_from_numpy(a, "cpu", dtype)

    from uvio_tpu_torch.math import quat_to_rot

    R_GtoI = quat_to_rot(torch.as_tensor(np.stack(qs))).numpy()
    R_ItoC = quat_to_rot(torch.as_tensor(q_ItoC)).numpy()
    Fc = 8
    # points in camera 0's frame of the newest clone, mapped to the world
    pc = np.stack([rng.uniform(-2, 2, Fc), rng.uniform(-1.5, 1.5, Fc), rng.uniform(4, 7, Fc)], 1)
    R_last = R_ItoC[0] @ R_GtoI[-1]
    p_C_last = ps[-1] - R_GtoI[-1].T @ (R_ItoC[0].T @ p_IinC[0])
    pts = pc @ R_last + p_C_last
    uv = np.zeros((Fc, K, cams, 2))
    mask = np.ones((Fc, K, cams), bool)
    for k in range(K):
        p_I = (pts - ps[k]) @ R_GtoI[k].T
        for c in range(cams):
            p_C = p_I @ R_ItoC[c].T + p_IinC[c]
            uvn = torch.as_tensor(p_C[:, :2] / p_C[:, 2:])
            uv[:, k, c] = cam_models.distort(torch.as_tensor(intr), cam_models.RADTAN, uvn).numpy()
    uv += rng.normal(size=uv.shape) * 0.4
    uv[2, 4, 0] += [60.0, -45.0]
    mask[6, 2:] = False
    mask[6, :, 1:] = False
    ids = np.arange(100, 100 + Fc)
    ids[5] = -1
    slots = np.array(free[:Fc])
    return Case(L, st, torch.as_tensor(uv), torch.as_tensor(mask), torch.as_tensor(slots),
                torch.as_tensor(ids), cam_models.RADTAN)


# ---------------------------------------------------------------------------
# a NumPy model of the C entry point
# ---------------------------------------------------------------------------


def model_work_bytes(D, Fc, M, itemsize):
    """`work_bytes` in `csrc/slam_init.cu`, field by field."""
    values = Fc * M * D + Fc * M + 9 * Fc + Fc + Fc * M * M + 3 * D + M * D + M * D + D
    return (values * itemsize + Fc * (D + 2) * 4 + 15) // 16 * 16


def _householder(A, Y):
    """LAPACK's geqr2 on A (M x 3), each reflection applied to the columns
    of Y too; returns (R (3 x 3), Y transformed)."""
    A, Y = A.copy(), Y.copy()
    M = A.shape[0]
    for j in range(3):
        alpha, x = A[j, j], A[j + 1:, j]
        xn2 = x @ x
        v = np.zeros(M, A.dtype)
        v[j] = 1
        tau = A.dtype.type(0)
        if xn2 != 0:
            beta = -np.copysign(np.sqrt(alpha * alpha + xn2), alpha)
            tau = (beta - alpha) / beta
            v[j + 1:] = x / (alpha - beta)
        for Z in (A, Y):
            w = v[j:] @ Z[j:]
            Z[j:] -= tau * np.outer(v[j:], w)
    return np.triu(A[:3]), Y


def _chol(S):
    try:
        return np.linalg.cholesky(S)
    except np.linalg.LinAlgError:
        return np.full_like(S, np.nan)


def model_entry(ptrs, ints, reals, stream):
    """`uvio_slam_init` as the kernel computes it, reading its pointer, int
    and real arrays as `csrc/slam_init.cu` does (one sequence after another
    where the kernel runs one cluster each, and the candidates one after
    another where it gates them ahead and keeps the first accepted).
    Returns 0, as cudaSuccess."""
    T = np.float64 if ints[0] else np.float32
    B, wbytes, D, Fc, M, cap, slam_off, S, freeze, n, slam_block = ints[1:12]
    assert wbytes == model_work_bytes(D, Fc, M, np.dtype(T).itemsize) and 1 <= n <= min(Fc, 8)
    blocks = km.table(ints[12:])
    assert blocks[slam_block][1] == S and blocks[slam_block][5] == 1
    nxt = km.reader(ptrs)
    cov_in = nxt(B * D * D, T).reshape(B, D, D)
    cov_out = nxt(B * D * D, T).reshape(B, D, D)
    hx = nxt(B * Fc * M * D, T).reshape(B, Fc, M, D)
    hf = nxt(B * Fc * M * 3, T).reshape(B, Fc, M, 3)
    res = nxt(B * Fc * M, T).reshape(B, Fc, M)
    thresh = nxt(B * Fc, np.float64).reshape(B, Fc)
    active = nxt(B * Fc, np.bool_).reshape(B, Fc)
    slots = nxt(B * Fc, np.int64).reshape(B, Fc)
    ids = nxt(B * Fc, np.int64).reshape(B, Fc)
    vals0 = nxt(B * Fc * 3, T).reshape(B, Fc, 3)
    anchor = nxt(B, np.int64)
    masks = km.masks(nxt, B, blocks)
    valid_out = nxt(B * S, np.bool_).reshape(B, S)
    fej_in, fej_out = (nxt(B * S * 3, T).reshape(B, S, 3) for _ in range(2))
    meta_in = [nxt(B * S, np.int64).reshape(B, S) for _ in range(3)]
    meta_out = [nxt(B * S, np.int64).reshape(B, S) for _ in range(3)]
    inited = nxt(B * Fc, np.bool_).reshape(B, Fc)
    chi2 = nxt(B * Fc, T).reshape(B, Fc)
    nxt(B * wbytes, np.uint8)
    outs = km.mean_blocks(nxt, B, blocks, T)
    s2 = T(reals[0])
    for b in range(B):
        P = cov_in[b].copy()
        fej_out[b] = fej_in[b]
        for k in range(3):
            meta_out[k][b] = meta_in[k][b]
        keep = km.keep(masks, b, blocks)
        for i in range(Fc):
            R, Y = _householder(hf[b, i], np.concatenate([hx[b, i], res[b, i][:, None]], 1))
            Hq, rq = Y[:, :D], Y[:, D]
            Hup, rup = Hq[3:], rq[3:]
            L = _chol(Hup @ P @ Hup.T + s2 * np.eye(M - 3, dtype=T))
            y = np.linalg.solve(L, rup) if np.isfinite(L).all() else np.full(M - 3, np.nan, T)
            # more live columns than shared memory holds: rejected, chi2 NaN
            gamma = T(y @ y) if (Hq != 0).any(0).sum() <= cap else T(np.nan)
            det = R[0, 0] * R[1, 1] * R[2, 2]
            ok = bool(active[b, i]) and float(gamma) < thresh[b, i] and abs(det) > T(1e-9)
            chi2[b, i], inited[b, i] = gamma, ok
            if not ok:
                continue
            slot = int(slots[b, i])
            off = slam_off + 3 * slot
            Hinv = np.linalg.inv(R).astype(T)
            Ma = P @ Hq[:3].T
            pll = Hinv @ (Hq[:3] @ Ma + s2 * np.eye(3, dtype=T)) @ Hinv.T
            cross = -Ma @ Hinv.T
            P[off:off + 3, :] = cross.T
            P[:, off:off + 3] = cross
            P[off:off + 3, off:off + 3] = pll
            outs[slam_block][b].reshape(S, 3)[slot] = vals0[b, i] + Hinv @ rq[:3]
            keep[slam_block][slot] = True
            fej_out[b, slot] = vals0[b, i]
            meta_out[0][b, slot], meta_out[1][b, slot], meta_out[2][b, slot] = ids[b, i], anchor[b], 0
            PHt = P @ Hup.T
            Sn = Hup @ PHt + s2 * np.eye(M - 3, dtype=T)
            Ln = _chol(T(0.5) * (Sn + Sn.T))
            K = np.linalg.solve(Ln.T, np.linalg.solve(Ln, PHt.T)).T
            P = P - K @ PHt.T
            P = T(0.5) * (P + P.T)
            if freeze:
                P[off:off + 2, :] = 0
                P[:, off:off + 2] = 0
            km.inject(outs, b, blocks, keep, K @ rup)
        cov_out[b] = P
        valid_out[b] = keep[slam_block]
    return 0


@pytest.fixture
def modelled_launch(monkeypatch):
    """CPU tensors take the delayed init's launch path (only its: the
    fixture's states come through the plain UWB drain), with `model_entry`
    as the library."""
    from uvio_tpu_torch import _build

    monkeypatch.setattr(slam, "launches", types.SimpleNamespace(**{**vars(launches), "route": lambda *t: True}))
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(uvio_slam_init=model_entry))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _assert_matches_plain(got, gi, want, wi, tol):
    assert torch.equal(gi["inited"], wi["inited"])
    finite = torch.isfinite(wi["chi2"])
    assert torch.equal(finite, torch.isfinite(gi["chi2"]))
    torch.testing.assert_close(gi["chi2"][finite], wi["chi2"][finite], rtol=tol, atol=tol)
    for name in FIELDS:
        x, y = getattr(got, name), getattr(want, name)
        if x.dtype.is_floating_point:
            scale = max(float(y.abs().max()), 1.0) if y.numel() else 1.0
            torch.testing.assert_close(x, y, rtol=0, atol=tol * scale, msg=name)
        else:
            assert torch.equal(x, y), name


CASES = {"fixture": fixture_case, "cell": cell_case,
         "stereo": lambda rep, **kw: cell_case(rep, cams=2, **kw)}


# ---------------------------------------------------------------------------
# the CPU route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_cpu_tensors_run_the_plain_version(name, monkeypatch):
    c = CASES[name](1)
    monkeypatch.setattr(slam, "_launch", lambda *a: pytest.fail("the kernel on CPU tensors"))
    before = dict(launches.launch_counts)
    got, gi = slam.slam_delayed_init(*c.args(), sigma_pix=c.sigma_pix)
    want, wi = slam.slam_delayed_init_ref(*c.args(), sigma_pix=c.sigma_pix)
    assert launches.launch_counts == before
    for n in FIELDS:
        assert torch.equal(getattr(got, n), getattr(want, n)), n
    assert torch.equal(gi["inited"], wi["inited"]) and torch.equal(gi["chi2"], wi["chi2"])
    assert wi["inited"].sum() >= 1


def test_kernel_ints_follow_the_layout():
    L = StateLayout(**CELL, slam_rep=ANCHORED_INVERSE_DEPTH_SINGLE)
    ints = slam.kernel_ints(L, 8)
    table = slam.inject_table(L)
    assert L.dim == 252 and ints[:10] == [252, 8, 24, 87, L.slam_off, 50, 1, 8,
                                          [b.field for b in table].index("slam_p"), len(table)]
    assert slam.cluster_size(3) == 3 and slam.kernel_ints(dataclasses.replace(L, slam_rep=1), 3)[6:8] == [0, 3]
    stereo = StateLayout(**dict(CELL, num_cams=2))
    assert stereo.dim == 266 and slam.kernel_ints(stereo, 8)[2:4] == [48, 101]
    with pytest.raises(ValueError, match="landmark slots"):
        slam.kernel_ints(StateLayout(max_clones=4), 8)
    assert slam.work_bytes(252, 8, 24, 8) == model_work_bytes(252, 8, 24, 8)


# ---------------------------------------------------------------------------
# the launch path with a NumPy model of the C entry point
# ---------------------------------------------------------------------------


def _run_both(c, chi2_mult=1.0):
    before = launches.launch_counts["slam_init"]
    got, gi = slam.slam_delayed_init(*c.args(), sigma_pix=c.sigma_pix, chi2_mult=chi2_mult)
    assert launches.launch_counts["slam_init"] == before + 1
    want, wi = slam.slam_delayed_init_ref(*c.args(), sigma_pix=c.sigma_pix, chi2_mult=chi2_mult)
    return got, gi, want, wi


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("name", CASES)
def test_modelled_launch_matches_the_plain_version(name, rep, modelled_launch):
    c = CASES[name](rep)
    got, gi, want, wi = _run_both(c)
    _assert_matches_plain(got, gi, want, wi, 1e-10)
    inited = wi["inited"].numpy()
    if name != "fixture":
        # the outlier, the inactive row and the short track fail; the rest pass
        assert not inited[[2, 5, 6]].any() and (inited.sum() == 5 if rep else inited.sum() >= 3), inited
        assert torch.equal(got.slam_id[c.slots[inited]], c.ids[inited])
    elif rep != 0:  # GLOBAL_3D's stricter baseline gate takes none of the fixture's
        assert inited.sum() >= 1
    # FEJ values of the rest of the state and the time axis are left as they were
    for n in ("q_fej", "p_fej", "v_fej", "clones_q_fej", "clones_p_fej", "time", "clones_t"):
        assert torch.equal(getattr(got, n), getattr(c.state, n)), n


def test_modelled_launch_float32(modelled_launch):
    c = cell_case(4).to(torch.float32)
    got, gi, want, wi = _run_both(c)
    assert gi["chi2"].dtype == torch.float32 and got.cov.dtype == torch.float32
    assert wi["inited"].sum() == 5
    _assert_matches_plain(got, gi, want, wi, 1e-4)


@pytest.mark.parametrize("name", CASES)
def test_modelled_launch_under_vmap_is_one_launch(name, modelled_launch):
    """The batch rule: three sequences (two states, and the first again
    with no active candidate) in one launch, each as its own plain init."""
    cases = [CASES[name](1, **({"seed": s} if name != "fixture" else {})) for s in range(2)]
    cases.append(dataclasses.replace(cases[0], ids=torch.full_like(cases[0].ids, -1)))
    L = cases[0].layout
    stack = lambda get: torch.stack([get(c) for c in cases])
    fields = tuple(stack(lambda c: getattr(c.state, n)) for n in FIELDS)
    before = launches.launch_counts["slam_init"]
    out, info = torch.func.vmap(
        lambda f, uv, m, s, i: (lambda o: (tuple(getattr(o[0], n) for n in FIELDS), o[1]))(
            slam.slam_delayed_init(FilterState(**dict(zip(FIELDS, f))), L, uv, m, s, i, cases[0].cam_model)))(
        fields, stack(lambda c: c.uv), stack(lambda c: c.mask), stack(lambda c: c.slots), stack(lambda c: c.ids))
    assert launches.launch_counts["slam_init"] == before + 1
    for b, c in enumerate(cases):
        want, wi = slam.slam_delayed_init_ref(*c.args())
        got = FilterState(**{n: f[b] for n, f in zip(FIELDS, out)})
        _assert_matches_plain(got, {k: v[b] for k, v in info.items()}, want, wi, 1e-10)
    assert info["inited"][:2].any() and not info["inited"][2].any()


def spoiled(systems, what, i):
    """`_candidate_systems` with candidate i's H_f spoiled: its third
    column zero ("singular", all candidates) or a NaN ("nonfinite")."""

    def spoil(*args):
        Hx, H_f, *rest = systems(*args)
        H_f = H_f.clone()
        if what == "singular":
            H_f[:, :, 2] = 0.0
        else:
            H_f[i, 0, 0] = float("nan")
        return (Hx, H_f, *rest)

    return spoil


@pytest.mark.parametrize("name", CASES)
def test_candidate_rows_lie_in_the_calibration_and_clone_columns(name):
    """The kernel's shared memory holds a candidate's H_x on at most
    `kernel_ints`' live-column cap, the columns from `calib_off` to
    `slam_off`: `_candidate_systems` writes nothing outside them."""
    c = CASES[name](1)
    L = c.layout
    Hx = slam._candidate_systems(c.state, L, c.uv, c.mask, c.ids, c.cam_model, c.sigma_pix)[0]
    assert not Hx[..., :L.calib_off].any() and not Hx[..., L.slam_off:].any()
    live = (Hx != 0).any(1).sum(1)
    assert int(live.max()) <= slam.kernel_ints(L, c.ids.shape[0])[3] == L.slam_off - L.calib_off


def _unchanged(got, gi, c, rows):
    assert not gi["inited"][rows].any()
    for n in FIELDS:
        assert torch.equal(getattr(got, n), getattr(c.state, n)), n


@pytest.mark.parametrize("what", ["gate", "inactive", "singular", "nonfinite"])
def test_a_rejected_candidate_changes_nothing(what, modelled_launch, monkeypatch):
    """Only one candidate offered: the outlier track (its chi2 fails), an
    inactive one (its id -1, though its track is good), a good track
    whose H_f has a zero column (a singular init block) and one whose H_f
    holds a NaN (every column of its split is then live, more than the
    kernel's shared memory holds): the state comes back as it went in,
    through the kernel's path and the plain version."""
    c = cell_case(1)
    keep = {"gate": 2, "inactive": 0, "singular": 1, "nonfinite": 3}[what]
    ids = torch.full_like(c.ids, -1)
    if what != "inactive":
        ids[keep] = c.ids[keep]
    c = dataclasses.replace(c, ids=ids)
    if what in ("singular", "nonfinite"):
        monkeypatch.setattr(slam, "_candidate_systems", spoiled(slam._candidate_systems, what, keep))
    got, gi, want, wi = _run_both(c)
    if what == "nonfinite":
        assert gi["chi2"][keep].isnan() and wi["chi2"][keep].isnan()
    if what == "singular":
        # H_f's third direction is arbitrary, so the update rows (and chi2)
        # of the two splits differ; the gate alone would take it
        assert wi["chi2"][keep] < 30 and gi["chi2"][keep] < 30
    else:
        _assert_matches_plain(got, gi, want, wi, 1e-10)
    _unchanged(got, gi, c, slice(None))
    _unchanged(want, wi, c, slice(None))


def test_launch_refuses_what_the_kernel_does_not_take(modelled_launch):
    c = cell_case(1)
    with pytest.raises(ValueError, match="target_slots"):
        slam.slam_delayed_init(c.state, c.layout, c.uv, c.mask, c.slots[:-1], c.ids, c.cam_model)
    with pytest.raises(TypeError, match="float32 or float64"):
        slam._launch(1, c.state.cov.half(), *[None] * 13, slam.kernel_ints(c.layout, 8), (1.0,))
    with pytest.raises(ValueError, match="landmark slots"):
        slam.kernel_ints(dataclasses.replace(c.layout, max_slam=0), 8)
    assert MASKS == ("clones_valid", "slam_valid", "anchors_valid")

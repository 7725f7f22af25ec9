"""The MSCKF update kernel's design and plumbing on the CPU (`update/msckf.py`,
the launch of `csrc/msckf_update.cu`).

The kernel runs only on the card (`tests/test_torch_msckf_kernel_cuda.py`).
What surrounds it is checked here, where a silent fault would hide:

  * CPU tensors run `msckf_update_ref`, bitwise, and launch nothing;
  * the whole launch path (routing, the launch's batch rule under
    `torch.func.vmap`, the pointer and int arrays, the outputs mapped back
    to the state) with the C entry point replaced by a float64 NumPy model
    of the kernel's arithmetic that reads the arrays as the kernel does:
    each feature's three Householder reflections in place on its unpacked
    rows and the W live columns, the gate on the live block of the
    covariance, the compression of the kept rows over the live columns, and
    the W-row EKF update. It holds the plain version (the packed rows'
    complete QR, the D-column compression and the D-row update) to 1e-12 of
    each field's largest magnitude in float64, with `kept`, `tri_ok`,
    `num_used` and `cov_ok` equal, and to 1e-4 in float32; one launch a
    call, batched or not;
  * the keep mask and `num_used` equal exactly with a feature whose
    residual holds a NaN, one seen once, and frames with no feature kept;
  * a feature's H_x lies in the camera calibration and clone columns, the
    W live columns the kernel holds, with every calibration switch on and
    two cameras.

States: the corridor cell's layout (D 130, W 75), the EuRoC cell's (D 252,
W 87), its stereo layout (D 266, W 101, 48 rows a feature), each with 40
features 4-7 m ahead seen over tracks of 2-12 clones with 0.4 px noise, an
outlier, a feature seen once and a padding row; `tests/test_torch_msckf.py`'s
scene (D 81); and the committed replay fixture's frames.

Imports neither JAX nor `uvio_tpu`, but for `test_torch_msckf.py`'s scene.
"""

import dataclasses
import types

import kernel_model as km
import numpy as np
import pytest
import torch

from test_torch_slam_init_kernel import _chol, _householder, _quat_from_rotvec
from uvio_tpu_torch import launches
from uvio_tpu_torch.cam import models as cam_models
from uvio_tpu_torch.filter.propagator import propagate_and_clone
from uvio_tpu_torch.fixtures import load_full_step_fixture
from uvio_tpu_torch.math import quat_to_rot
from uvio_tpu_torch.math.chi2 import MAX_DOF
from uvio_tpu_torch.pipeline import FullStepConfig, _uwb_drain, bundle_from_numpy, plan_frame
from uvio_tpu_torch.types.layout import StateLayout
from uvio_tpu_torch.types.state import FIELDS, FilterState, init_state, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import msckf

T64 = torch.float64
LAYOUTS = {
    "corridor": dict(max_clones=12, max_anchors=8, calib_uwb_extrinsics=True, max_imu_batch=64),
    "euroc": dict(max_clones=12, max_slam=50, calib_cam_timeoffset=True, calib_cam_pose=True,
                  calib_cam_intrinsics=True, slam_rep=1, max_imu_batch=64),
    "stereo": dict(max_clones=12, max_slam=50, num_cams=2, calib_cam_timeoffset=True, calib_cam_pose=True,
                   calib_cam_intrinsics=True, slam_rep=1, max_imu_batch=64),
}
INTR = np.array([458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])


@dataclasses.dataclass
class Case:
    layout: StateLayout
    state: FilterState
    uv: torch.Tensor  # (F,K,C,2)
    mask: torch.Tensor  # (F,K,C)
    cam_model: int = cam_models.RADTAN
    sigma_pix: float = 1.0

    def args(self):
        return (self.state, self.layout, self.cam_model, self.uv, self.mask)

    def to(self, dtype):
        return dataclasses.replace(self, state=state_from_numpy(state_to_numpy(self.state), "cpu", dtype))


def layout_case(name, seed=0, F=40):
    """A state on layout `name`: 12 clones 8 cm apart on a gently turning
    path, the cameras a few cm and degrees off the IMU with radtan
    intrinsics of 752x480 (camera 1 11 cm to camera 0's right), anchors and
    landmarks where the layout has slots, a dense SPD covariance of a few cm
    and mrad (zero on the free landmark slots); F features at points 4-7 m
    ahead of the newest camera, each seen over a run of 2-12 clones (by one
    or both cameras) with 0.4 px noise. Feature 2 has one observation 75 px
    off (its gate fails), feature 5 is seen once (too few rows), feature 8
    is a padding row (no observation)."""
    rng = np.random.default_rng(seed)
    L = StateLayout(**LAYOUTS[name])
    K, C, D = L.max_clones, L.num_cams, L.dim
    a = state_to_numpy(init_state(L, device="cpu"))
    qs = [_quat_from_rotvec(np.array([0.01 * k, 0.02 * k, 0.005 * k])) for k in range(K)]
    ps = [np.array([0.08 * k, 0.01 * np.sin(k), 0.02 * k]) for k in range(K)]
    q_ItoC = np.stack([_quat_from_rotvec(np.array([0.01, -0.02, 0.015])),
                       _quat_from_rotvec(np.array([-0.005, 0.01, 0.02]))])[:C]
    p_IinC = np.array([[0.05, -0.03, 0.01], [-0.06, -0.028, 0.012]])[:C]
    a.update(clones_q=np.stack(qs), clones_p=np.stack(ps), clones_q_fej=np.stack(qs), clones_p_fej=np.stack(ps),
             clones_valid=np.ones(K, bool), clones_t=np.arange(K) * 0.05, clone_head=np.array(K - 1),
             q=qs[-1], p=ps[-1], time=np.array((K - 1) * 0.05),
             calib_cam_q=q_ItoC, calib_cam_p=p_IinC, calib_cam_intr=np.stack([INTR] * C))
    zero = []
    if L.max_slam:
        a["slam_valid"][[0, 3]] = True
        a["slam_p"][[0, 3]] = rng.normal(size=(2, 3))
        zero = [L.slam_off + 3 * s + i for s in range(L.max_slam) if not a["slam_valid"][s] for i in range(3)]
    if L.max_anchors:
        a["anchors_valid"][:4] = True
        a["anchors_p"][:4] = rng.normal(size=(4, 3)) * 5
    Mx = rng.normal(size=(D, D)) * 0.0006
    cov = Mx @ Mx.T + np.diag(np.full(D, 4e-6))
    cov[zero, :] = 0
    cov[:, zero] = 0
    a["cov"] = cov
    st = state_from_numpy(a, "cpu", T64)

    R_GtoI = quat_to_rot(torch.as_tensor(np.stack(qs))).numpy()
    R_ItoC = quat_to_rot(torch.as_tensor(q_ItoC)).numpy()
    pc = np.stack([rng.uniform(-2, 2, F), rng.uniform(-1.5, 1.5, F), rng.uniform(4, 7, F)], 1)
    pts = pc @ (R_ItoC[0] @ R_GtoI[-1]) + ps[-1] - R_GtoI[-1].T @ (R_ItoC[0].T @ p_IinC[0])
    uv = np.zeros((F, K, C, 2))
    for k in range(K):
        p_I = (pts - ps[k]) @ R_GtoI[k].T
        for c in range(C):
            p_C = p_I @ R_ItoC[c].T + p_IinC[c]
            uv[:, k, c] = cam_models.distort(torch.as_tensor(INTR), cam_models.RADTAN,
                                             torch.as_tensor(p_C[:, :2] / p_C[:, 2:])).numpy()
    uv += rng.normal(size=uv.shape) * 0.4
    start = rng.integers(0, K - 1, F)
    length = rng.integers(2, K + 1, F)
    k = np.arange(K)
    seen = (k[None] >= start[:, None]) & (k[None] < start[:, None] + length[:, None])
    mask = np.repeat(seen[:, :, None], C, axis=2)
    if C > 1:
        mask[rng.random(F) < 0.3, :, 1] = False
    uv[2, start[2], 0] += [60.0, -45.0]
    mask[2, :, 0] = seen[2]
    mask[5] = False
    mask[5, K - 1, 0] = True
    mask[8] = False
    return Case(L, st, torch.as_tensor(uv), torch.as_tensor(mask))


def scene_case(seed=2):
    """`tests/test_torch_msckf.py`'s scene (built with `uvio_tpu`)."""
    from test_torch_msckf import K, _port, _scene

    _, st, uv, mask = _scene(seed)
    return Case(StateLayout(max_clones=K, max_slam=0), _port(st), torch.as_tensor(uv), torch.as_tensor(mask))


def fixture_case(frame=3):
    """The fixture's float64 state on `frame` after the UWB drain and
    propagate+clone, with the frame's MSCKF features."""
    fx = load_full_step_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    arrays, b = fx.snapshots[frame], fx.bundles[frame]
    fb = bundle_from_numpy(b, device="cpu", dtype=T64)
    L = cfg.layout
    st, _, _ = _uwb_drain(state_from_numpy(arrays, "cpu", T64), fb, plan_frame(b, arrays["time"]), cfg)
    st = propagate_and_clone(st, L, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises, cfg.gravity_mag,
                             stamp_time=fb.stamp_time)
    return Case(L, st, fb.msckf_uv, fb.msckf_mask, cfg.cam_model, cfg.sigma_pix)


CASES = {"corridor": lambda **kw: layout_case("corridor", **kw), "euroc": lambda **kw: layout_case("euroc", **kw),
         "stereo": lambda **kw: layout_case("stereo", **kw), "scene": lambda **kw: scene_case(),
         "fixture": lambda **kw: fixture_case()}


# ---------------------------------------------------------------------------
# a NumPy model of the C entry point
# ---------------------------------------------------------------------------


def model_work_bytes(is_double, D, F, M, W):
    """`uvio_msckf_work_bytes` in `csrc/msckf_update.cu`, field by field."""
    itemsize = 8 if is_double else 4
    values = F * (M - 3) * (W + 1) + W * (W + 1) + W * D + W * W + W * D + D + D
    return (values * itemsize + 16 * 4 + 15) // 16 * 16


def model_entry(ptrs, ints, reals, stream):
    """`uvio_msckf_update` as the kernel computes it, reading its pointer,
    int and real arrays as `csrc/msckf_update.cu` does (one sequence after
    another where the kernel runs one cluster each). Returns 0, as
    cudaSuccess."""
    T = np.float64 if ints[0] else np.float32
    B, D, F, M, c0, W = ints[1:7]
    m = M - 3
    wbytes = model_work_bytes(ints[0], D, F, M, W)
    blocks = km.table(ints[7:])
    nxt = km.reader(ptrs)
    cov_in = nxt(B * D * D, T).reshape(B, D, D)
    cov_out = nxt(B * D * D, T).reshape(B, D, D)
    hx = nxt(B * F * M * D, T).reshape(B, F, M, D)
    hf = nxt(B * F * M * 3, T).reshape(B, F, M, 3)
    res = nxt(B * F * M, T).reshape(B, F, M)
    row_mask = nxt(B * F * M, np.bool_).reshape(B, F, M)
    tri_ok = nxt(B * F, np.bool_).reshape(B, F)
    quantiles = nxt(MAX_DOF + 1, np.float64)
    masks = km.masks(nxt, B, blocks)
    kept = nxt(B * F, np.bool_).reshape(B, F)
    chi2 = nxt(B * F, T).reshape(B, F)
    num_used = nxt(B, np.int64)
    cov_ok = nxt(B, np.bool_)
    nxt(B * wbytes, np.uint8)
    outs = km.mean_blocks(nxt, B, blocks, T)
    s2, mult = T(reals[0]), reals[1]
    live = slice(c0, c0 + W)
    for b in range(B):
        P = cov_in[b]
        Pll = P[live, live]
        stack = []
        for f in range(F):
            rows = int(row_mask[b, f].sum())
            if not (tri_ok[b, f] and rows >= 4):  # no rows
                chi2[b, f], kept[b, f] = 0, False
                continue
            _, Y = _householder(hf[b, f], np.concatenate([hx[b, f][:, live], res[b, f][:, None]], 1))
            Hp, rp = Y[3:, :W], Y[3:, W]
            L = _chol(Hp @ Pll @ Hp.T + s2 * np.eye(m, dtype=T))
            y = np.linalg.solve(L, rp) if np.isfinite(L).all() else np.full(m, np.nan, T)
            gamma = T(y @ y)
            keep = float(gamma) < mult * quantiles[min(max(rows - 3, 1), m)]
            chi2[b, f], kept[b, f] = gamma, keep
            stack.append(Y[3:] * T(keep))
        stack = np.concatenate(stack) if stack else np.zeros((0, W + 1), T)
        Ra = np.linalg.qr(stack, mode="r") if len(stack) else np.zeros((0, W + 1), T)
        Ra = np.concatenate([Ra, np.zeros((max(W - len(Ra), 0), W + 1), T)])[:W]
        R, r_c = np.triu(Ra[:, :W]), Ra[:, W]
        PHt = P[:, live] @ R.T
        S = R @ PHt[live] + s2 * np.eye(W, dtype=T)
        Ls = _chol(T(0.5) * (S + S.T))
        K = np.linalg.solve(Ls.T, np.linalg.solve(Ls, PHt.T)).T if np.isfinite(Ls).all() else np.full_like(PHt, np.nan)
        Pn = P - K @ PHt.T
        cov_out[b] = T(0.5) * (Pn + Pn.T)
        d = np.diagonal(cov_out[b])
        eps = np.finfo(T).eps
        tol = max(T(32) * eps * max(d.max(), T(1)), T(1e-9))
        cov_ok[b] = bool((d > -tol).all())
        num_used[b] = kept[b].sum()
        km.inject(outs, b, blocks, km.keep(masks, b, blocks), K @ r_c)
    return 0


@pytest.fixture
def modelled_launch(monkeypatch):
    """CPU tensors take the MSCKF update's launch path, with `model_entry`
    as the library."""
    from uvio_tpu_torch import _build

    monkeypatch.setattr(msckf, "launches", types.SimpleNamespace(**{**vars(launches), "route": lambda *t: True}))
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(uvio_msckf_update=model_entry,
                                                                      uvio_msckf_work_bytes=model_work_bytes))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))


def assert_matches_plain(got, gi, want, wi, tol):
    """Decisions equal; chi2 and every float field within `tol` of its
    largest magnitude (NaN where the plain version has NaN)."""
    for k in ("tri_ok", "kept", "num_used", "cov_ok"):
        assert torch.equal(gi[k], wi[k]), k
    finite = torch.isfinite(wi["chi2"])
    assert torch.equal(finite, torch.isfinite(gi["chi2"]))
    torch.testing.assert_close(gi["chi2"][finite], wi["chi2"][finite], rtol=tol, atol=tol)
    for name in FIELDS:
        x, y = getattr(got, name), getattr(want, name)
        if x.dtype.is_floating_point:
            fin = y[torch.isfinite(y)]
            scale = max(float(fin.abs().max()), 1.0) if fin.numel() else 1.0
            torch.testing.assert_close(x, y, rtol=0, atol=tol * scale, equal_nan=True, msg=name)
        else:
            assert torch.equal(x, y), name


def run_both(c, chi2_mult=1.0):
    before = launches.launch_counts["msckf_update"]
    got, gi = msckf.msckf_update(*c.args(), sigma_pix=c.sigma_pix, chi2_mult=chi2_mult)
    assert launches.launch_counts["msckf_update"] == before + 1
    want, wi = msckf.msckf_update_ref(*c.args(), sigma_pix=c.sigma_pix, chi2_mult=chi2_mult)
    return got, gi, want, wi


# ---------------------------------------------------------------------------
# the CPU route and the kernel's arguments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["corridor", "euroc"])
def test_cpu_tensors_run_the_plain_version(name, monkeypatch):
    c = CASES[name]()
    monkeypatch.setattr(msckf, "_launch", lambda *a: pytest.fail("the kernel on CPU tensors"))
    before = dict(launches.launch_counts)
    got, gi = msckf.msckf_update(*c.args(), sigma_pix=c.sigma_pix)
    want, wi = msckf.msckf_update_ref(*c.args(), sigma_pix=c.sigma_pix)
    assert launches.launch_counts == before
    for n in FIELDS:
        assert torch.equal(getattr(got, n), getattr(want, n)), n
    for k in wi:
        assert torch.equal(gi[k], wi[k]), k
    assert 25 <= int(wi["num_used"]) < 40


def test_kernel_ints_follow_the_layout():
    corridor, euroc, stereo = (StateLayout(**LAYOUTS[n]) for n in ("corridor", "euroc", "stereo"))
    assert msckf.kernel_ints(corridor, 40)[:5] == [130, 40, 24, 15, 75]
    assert msckf.kernel_ints(euroc, 40)[:5] == [252, 40, 24, 15, 87]
    assert msckf.kernel_ints(stereo, 40)[:5] == [266, 40, 48, 15, 101]
    assert msckf.kernel_ints(euroc, 40)[5:] == msckf.table_ints(msckf.inject_table(euroc))


# ---------------------------------------------------------------------------
# the launch path with a NumPy model of the C entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_modelled_launch_matches_the_plain_version(name, modelled_launch):
    c = CASES[name]()
    got, gi, want, wi = run_both(c)
    assert_matches_plain(got, gi, want, wi, 1e-12)
    kept = wi["kept"].numpy()
    if name in LAYOUTS:  # the outlier, the feature seen once and the padding row fail
        assert not kept[[2, 5, 8]].any() and kept.sum() >= 25, kept
        assert not wi["tri_ok"][8] or int(c.mask[8].sum()) == 0
    else:
        assert kept.sum() >= 1
    for n in ("q_fej", "p_fej", "v_fej", "clones_q_fej", "clones_p_fej", "time", "clones_t"):
        assert torch.equal(getattr(got, n), getattr(c.state, n)), n


@pytest.mark.parametrize("name", ["corridor", "euroc"])
def test_modelled_launch_float32(name, modelled_launch):
    c = CASES[name]().to(torch.float32)
    got, gi, want, wi = run_both(c)
    assert gi["chi2"].dtype == torch.float32 and got.cov.dtype == torch.float32
    assert wi["num_used"] >= 25
    assert_matches_plain(got, gi, want, wi, 1e-4)


@pytest.mark.parametrize("name", ["corridor", "stereo"])
def test_modelled_launch_under_vmap_is_one_launch(name, modelled_launch):
    """The batch rule: three sequences (two states, and the first again
    with no observation) in one launch, each as its own plain update."""
    cases = [CASES[name](seed=s) for s in range(2)]
    cases.append(dataclasses.replace(cases[0], mask=torch.zeros_like(cases[0].mask)))
    L = cases[0].layout
    stack = lambda get: torch.stack([get(c) for c in cases])  # noqa: E731
    fields = tuple(stack(lambda c: getattr(c.state, n)) for n in FIELDS)
    before = launches.launch_counts["msckf_update"]
    out, info = torch.func.vmap(
        lambda f, uv, m: (lambda o: (tuple(getattr(o[0], n) for n in FIELDS), o[1]))(
            msckf.msckf_update(FilterState(**dict(zip(FIELDS, f))), L, cases[0].cam_model, uv, m)))(
        fields, stack(lambda c: c.uv), stack(lambda c: c.mask))
    assert launches.launch_counts["msckf_update"] == before + 1
    for b, c in enumerate(cases):
        want, wi = msckf.msckf_update_ref(*c.args())
        got = FilterState(**{n: f[b] for n, f in zip(FIELDS, out)})
        assert_matches_plain(got, {k: v[b] for k, v in info.items()}, want, wi, 1e-12)
    assert info["num_used"][:2].min() >= 25 and info["num_used"][2] == 0


def with_nan_residual(systems, f):
    """`msckf._systems` with feature f's first residual NaN."""

    def spoil(*args):
        Hx, H_f, res, *rest = systems(*args)
        res = res.clone()
        res[f, 0] = float("nan")
        return (Hx, H_f, res, *rest)

    return spoil


@pytest.mark.parametrize("what", ["nan", "no_observation", "all_rejected"])
def test_keep_mask_and_count_are_exact(what, modelled_launch, monkeypatch):
    """A feature whose residual holds a NaN is rejected with chi2 NaN (and
    its zero weight spreads the NaN into the correction, in both); a frame
    with no observation and one whose gate rejects every feature keep none
    and leave the covariance symmetric as it was."""
    c = layout_case("euroc")
    mult = 1.0
    if what == "nan":
        monkeypatch.setattr(msckf, "_systems", with_nan_residual(msckf._systems, 4))
    elif what == "no_observation":
        c = dataclasses.replace(c, mask=torch.zeros_like(c.mask))
    else:
        mult = 1e-9
    got, gi, want, wi = run_both(c, chi2_mult=mult)
    assert_matches_plain(got, gi, want, wi, 1e-12)
    if what == "nan":
        assert gi["chi2"][4].isnan() and not gi["kept"][4] and gi["num_used"] >= 25
        assert got.p.isnan().all() and want.p.isnan().all() and torch.isfinite(got.cov).all()
    else:
        assert gi["num_used"] == 0 and not gi["kept"].any()
        torch.testing.assert_close(got.cov, c.state.cov, rtol=0, atol=1e-18)
        if what == "no_observation":
            assert (gi["chi2"] == 0).all()


def test_launch_refuses_what_the_kernel_does_not_take(modelled_launch):
    c = layout_case("corridor")
    with pytest.raises(TypeError, match="float32 or float64"):
        msckf._launch(1, c.state.cov.half(), *[None] * 6, [], [], msckf.kernel_ints(c.layout, 40), (1.0, 1.0))
    bad = msckf.kernel_ints(c.layout, 40)
    bad[1] = 39
    with pytest.raises(ValueError, match="H_x"):
        msckf.launches.Launch.apply(msckf._launch, *_launch_inputs(c), bad, (1.0, 1.0))


def _launch_inputs(c):
    from uvio_tpu_torch.math.chi2 import _device_table

    Hx, H_f, res, rm, ok = msckf._systems(*c.args(), c.sigma_pix)
    table = msckf.inject_table(c.layout)
    return (c.state.cov, Hx, H_f, res, rm, ok, _device_table(c.state.cov.device),
            [getattr(c.state, m) for m in msckf.MASKS], [getattr(c.state, b.field) for b in table])


# ---------------------------------------------------------------------------
# where a feature's H_x lies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["stereo_all_calibration", "euroc", "corridor"])
def test_feature_rows_lie_in_the_calibration_and_clone_columns(name):
    """The kernel holds a feature's H_x on the W columns from `calib_off`
    to `slam_off`: `feature_system` writes nothing outside them, with every
    calibration switch on (IMU intrinsics with g-sensitivity, camera time
    offset, extrinsics and intrinsics, the UWB lever arm), anchors and
    landmark slots, and two cameras."""
    if name == "stereo_all_calibration":
        LAYOUTS_ALL = dict(LAYOUTS["stereo"], calib_uwb_extrinsics=True, max_anchors=4, calib_imu_intrinsics=True,
                           calib_imu_g_sensitivity=True)
        c = layout_case("stereo")
        L = StateLayout(**LAYOUTS_ALL)
        st = state_from_numpy({**state_to_numpy(init_state(L, device="cpu")),
                               **{k: v for k, v in state_to_numpy(c.state).items()
                                  if k not in ("cov",) and not k.startswith(("anchors", "calib_imu", "uwb"))}},
                              "cpu", T64)
        c = dataclasses.replace(c, layout=L, state=st.replace(cov=torch.eye(L.dim, dtype=T64) * 1e-4))
    else:
        c = CASES[name]()
    L = c.layout
    Hx = msckf._systems(*c.args(), c.sigma_pix)[0]
    assert not Hx[..., :L.calib_off].any() and not Hx[..., L.slam_off:].any()
    assert Hx[..., L.calib_off:L.slam_off].any()
    assert msckf.kernel_ints(L, 40)[4] == L.slam_off - L.calib_off

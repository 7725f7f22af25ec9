"""The UWB kernel's plumbing on the CPU (`update/uwb.py`, the launch of
`csrc/uwb_update.cu`).

The kernel runs only on the card (`tests/test_torch_uwb_kernel_cuda.py`).
What surrounds it is checked here, where a silent fault would hide:

  * `inject_table` and `kernel_ints`, the ints the kernel gets in place of
    the layout, against `StateLayout` on six layouts (lever arm or not,
    camera calibration, SLAM slots, IMU intrinsics in both models): the
    table's error rows partition the error state, its blocks are the
    state's fields, and the same correction through the table equals
    `filter.ekf.inject`;
  * CPU tensors run `uwb_update_ref`, bitwise, and launch nothing;
  * the whole launch path (routing, the launch's batch rule under
    `torch.func.vmap`, the pointer and int arrays, the outputs
    mapped back to the state) with the C entry point replaced by a NumPy
    model of it that reads the arrays as the kernel does. It holds the
    plain version to 1e-12 relative in float64 (the sums run in another
    order) and 1e-4 in float32, with equal accept decisions, and counts
    one launch a call, batched or not.

Imports neither JAX nor `uvio_tpu`.
"""

import dataclasses
import os
import re
import types

import kernel_model as km
import numpy as np
import pytest
import torch

from uvio_tpu_torch import _build, launches
from uvio_tpu_torch.filter.ekf import inject
from uvio_tpu_torch.types.layout import IMU_MODEL_KALIBR, IMU_MODEL_RPNG, StateLayout
from uvio_tpu_torch.types.state import FIELDS, FilterState, init_state, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import uwb

LAYOUTS = {
    "corridor": StateLayout(max_clones=12, max_anchors=8, calib_uwb_extrinsics=True, max_imu_batch=64),
    "no_lever_arm": StateLayout(max_clones=5, max_anchors=4),
    "camera_calib": StateLayout(max_clones=4, max_anchors=3, num_cams=2, calib_cam_timeoffset=True,
                                calib_cam_pose=True, calib_cam_intrinsics=True, calib_uwb_extrinsics=True),
    "slam": StateLayout(max_clones=6, max_slam=7, max_anchors=4, calib_uwb_extrinsics=True),
    "imu_kalibr_g": StateLayout(max_clones=4, max_anchors=4, calib_imu_intrinsics=True,
                                calib_imu_g_sensitivity=True, imu_model=IMU_MODEL_KALIBR),
    "imu_rpng": StateLayout(max_clones=4, max_slam=2, max_anchors=5, calib_imu_intrinsics=True,
                            imu_model=IMU_MODEL_RPNG, calib_uwb_extrinsics=True),
}


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / (np.linalg.norm(q, axis=1, keepdims=True) * np.sign(q[:, 3:4]))


def random_state(layout, seed=0, dtype=torch.float64):
    """A CPU state with random means in every block, some clone, landmark
    and anchor slots invalid, and an SPD covariance of a few cm scale."""
    rng = np.random.default_rng(seed)
    L = layout
    K, S, A, C, D = L.max_clones, L.max_slam, L.max_anchors, L.num_cams, L.dim
    a = state_to_numpy(init_state(L, device="cpu"))
    a.update(
        q=_unit_quats(rng, 1)[0], p=rng.normal(size=3), v=rng.normal(size=3),
        bg=rng.normal(size=3) * 1e-3, ba=rng.normal(size=3) * 1e-2,
        clones_q=_unit_quats(rng, K), clones_p=rng.normal(size=(K, 3)),
        clones_valid=rng.random(K) < 0.7, slam_p=rng.normal(size=(S, 3)) * 4, slam_valid=rng.random(S) < 0.6,
        calib_imu_dw=a["calib_imu_dw"] + rng.normal(size=6) * 1e-3,
        calib_imu_da=a["calib_imu_da"] + rng.normal(size=6) * 1e-3,
        calib_imu_tg=rng.normal(size=9) * 1e-4, calib_imu_gq=_unit_quats(rng, 1)[0],
        calib_imu_aq=_unit_quats(rng, 1)[0], calib_dt=np.array(rng.normal() * 1e-3),
        calib_cam_q=_unit_quats(rng, C), calib_cam_p=rng.normal(size=(C, 3)) * 0.1,
        calib_cam_intr=a["calib_cam_intr"] + rng.normal(size=(C, 8)) * 1e-3,
        uwb_p_IinU=rng.normal(size=3) * 0.1,
        anchors_p=rng.normal(size=(A, 3)) * 6, anchors_gamma=rng.normal(size=A) * 0.2,
        anchors_alpha=rng.normal(size=A) * 0.02, anchors_valid=np.arange(A) != A - 2,
    )
    M = rng.normal(size=(D, D)) * 0.004
    a["cov"] = M @ M.T + 1e-4 * np.eye(D)
    return state_from_numpy(a, "cpu", dtype)


def ranges_for(state, layout, seed=0):
    """Ranges of the true anchors from a pose 10 cm off the state's, with
    0.05 m noise; slot 0 a 3 m outlier, slot 1 masked out. Returns
    (ranges (A,) float64, mask (A,) bool)."""
    rng = np.random.default_rng(seed + 100)
    A = layout.max_anchors
    ys = []
    for a in range(A):
        moved = state.replace(p=state.p + torch.tensor([0.08, -0.05, 0.03], dtype=state.p.dtype))
        ys.append(float(uwb.predicted_range(moved, a)[0]))
    ranges = np.asarray(ys) + rng.normal(size=A) * 0.05
    ranges[0] += 3.0
    mask = np.ones(A, bool)
    mask[1] = False
    return torch.as_tensor(ranges), torch.as_tensor(mask)


def _header_source():
    with open(os.path.join(_build.CSRC_DIR, "mean_table.cuh")) as f:
        return f.read()


# ---------------------------------------------------------------------------
# the table and the ints against the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LAYOUTS)
def test_table_partitions_the_error_state(name):
    L = LAYOUTS[name]
    st = init_state(L, device="cpu")
    covered = np.zeros(L.dim, int)
    for b in uwb.inject_table(L):
        field = getattr(st, b.field)
        assert field.numel() == b.rows * b.width, b
        rows_of = {0: (), 1: (b.width,) if b.rows == 1 else (b.rows,), 2: (b.rows, b.width)}
        assert tuple(field.shape) == rows_of[field.dim()] and (field.dim() or b.rows * b.width == 1), b
        assert b.field not in ("time", "clones_t") and field.dtype == st.cov.dtype, b
        per_row = 3 if b.quat else b.width
        assert b.err_stride >= per_row and (not b.quat or b.width == 4), b
        for r in range(b.rows):
            covered[b.err_off + r * b.err_stride: b.err_off + r * b.err_stride + per_row] += 1
        if b.mask is not None:
            assert getattr(st, b.mask).shape == (b.rows,), b
    # every error coordinate belongs to exactly one mean block
    np.testing.assert_array_equal(covered, np.ones(L.dim, int))


@pytest.mark.parametrize("name", LAYOUTS)
def test_kernel_ints_follow_the_layout(name):
    L = LAYOUTS[name]
    table = uwb.inject_table(L)
    ints = uwb.kernel_ints(L)
    names = [b.field for b in table]
    head = [L.dim, L.max_anchors, L.theta_off, L.p_off,
            L.calib_uwb_off if L.calib_uwb_extrinsics else -1, L.anchor_off,
            names.index("q"), names.index("p"),
            names.index("uwb_p_IinU") if L.calib_uwb_extrinsics else -1,
            names.index("anchors_p"), names.index("anchors_gamma"), names.index("anchors_alpha"), len(table)]
    assert ints[:13] == head
    max_blocks = int(re.search(r"constexpr int kMaxBlocks = (\d+);", _header_source()).group(1))
    assert len(ints) == 13 + 6 * len(table) and len(table) <= max_blocks
    for k, b in enumerate(table):
        mask = uwb.MASKS.index(b.mask) if b.mask else -1
        assert ints[13 + 6 * k: 19 + 6 * k] == [int(b.quat), b.rows, b.width, b.err_off, b.err_stride, mask]
    # blocks by what the layout has
    assert ("slam_p" in names) == (L.max_slam > 0)
    assert ("calib_dt" in names) == L.calib_cam_timeoffset
    assert ("calib_cam_q" in names) == ("calib_cam_p" in names) == L.calib_cam_pose
    assert ("calib_cam_intr" in names) == L.calib_cam_intrinsics
    assert ("calib_imu_tg" in names) == (L.calib_imu_intrinsics and L.calib_imu_g_sensitivity)
    assert ("calib_imu_gq" in names) == (L.calib_imu_intrinsics and L.imu_model == IMU_MODEL_KALIBR)
    assert ("calib_imu_aq" in names) == (L.calib_imu_intrinsics and L.imu_model == IMU_MODEL_RPNG)


def test_kernel_ints_refuse_a_layout_without_anchors():
    with pytest.raises(ValueError, match="anchors"):
        uwb.kernel_ints(StateLayout(max_clones=4))


@pytest.mark.parametrize("name", LAYOUTS)
def test_inject_by_the_table_is_inject(name):
    """The correction applied block by block as the kernel applies it
    (quaternion rows by the error quaternion's product, the rest added,
    masked rows left) is `filter.ekf.inject`'s."""
    from uvio_tpu_torch.filter.ekf import _dq
    from uvio_tpu_torch.math import quat_multiply

    L = LAYOUTS[name]
    st = random_state(L, seed=3)
    dx = torch.as_tensor(np.random.default_rng(4).normal(size=L.dim) * 0.05)
    want = inject(st, L, dx)
    got = {}
    for b in uwb.inject_table(L):
        x = getattr(st, b.field).reshape(b.rows, b.width)
        keep = torch.ones(b.rows, dtype=torch.bool) if b.mask is None else getattr(st, b.mask)
        rows = []
        for r in range(b.rows):
            e = dx[b.err_off + r * b.err_stride: b.err_off + r * b.err_stride + (3 if b.quat else b.width)]
            new = quat_multiply(_dq(e), x[r]) if b.quat else x[r] + e
            rows.append(new if keep[r] else x[r])
        got[b.field] = torch.stack(rows).reshape(getattr(st, b.field).shape)
    for n in FIELDS:
        if n in got:
            torch.testing.assert_close(got[n], getattr(want, n), rtol=0, atol=1e-15, msg=n)
        else:  # a field the table leaves is one inject leaves
            assert torch.equal(getattr(want, n), getattr(st, n)), n


def test_shared_memory_by_shape(modelled_launch):
    """`uses_shared_memory` asks the library with the launch's ints
    (precision, one sequence, `kernel_ints`), here a model of it: the
    corridor's float64 covariance is staged; with 25 SLAM slots (D 205) it
    is updated in global memory in float64 and staged in float32. The
    bytes are the kernel's: two D-vectors, the mean, the ranges and the
    covariance in values, a byte a block row and a slot."""
    L = LAYOUTS["corridor"]
    slam = dataclasses.replace(L, max_slam=25)
    assert L.dim == 130 and slam.dim == 205
    assert uwb.uses_shared_memory(L, torch.float64)
    assert not uwb.uses_shared_memory(slam, torch.float64) and uwb.uses_shared_memory(slam, torch.float32)
    mean = sum(b.rows * b.width for b in uwb.inject_table(L))
    rows = sum(b.rows for b in uwb.inject_table(L))
    assert mean == 4 + 4 * 3 + 12 * 7 + 3 + 8 * 5 and rows == 5 + 2 * 12 + 1 + 3 * 8
    ints = [1, 1, *uwb.kernel_ints(L)]
    assert model_shared_bytes(ints) == (2 * 130 + mean + 8 + 130 * 130) * 8 + rows + 8


# ---------------------------------------------------------------------------
# the CPU route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["corridor", "slam"])
def test_cpu_tensors_run_the_plain_version(name, monkeypatch):
    L = LAYOUTS[name]
    st = random_state(L, seed=1)
    ranges, mask = ranges_for(st, L)
    monkeypatch.setattr(uwb, "_launch", lambda *a: pytest.fail("the kernel on CPU tensors"))
    before = dict(launches.launch_counts)
    got, gi = uwb.uwb_update(st, L, ranges, mask, sigma_range=0.1)
    want, wi = uwb.uwb_update_ref(st, L, ranges, mask, sigma_range=0.1)
    assert launches.launch_counts == before
    for n in FIELDS:
        assert torch.equal(getattr(got, n), getattr(want, n)), n
    assert torch.equal(gi["accepted"], wi["accepted"]) and torch.equal(gi["chi2"], wi["chi2"])
    # slot 0 is an outlier, slot 1 masked, slot A-2 an invalid anchor
    acc = wi["accepted"].numpy()
    assert not acc[0] and not acc[1] and not acc[L.max_anchors - 2] and acc.sum() >= 1


# ---------------------------------------------------------------------------
# the launch path with a NumPy model of the C entry point
# ---------------------------------------------------------------------------


def model_entry(ptrs, ints, reals, stream):
    """`uvio_uwb_update` as the kernel computes it, reading its pointer,
    int and real arrays as `csrc/uwb_update.cu` does (one sequence after
    another where the kernel runs one block each). Returns 0, as
    cudaSuccess."""
    T = np.float64 if ints[0] else np.float32
    B, D, A = ints[1], ints[2], ints[3]
    theta_off, p_off, lever_off, anchor_off = ints[4:8]
    q_b, p_b, lever_b, ap_b, ag_b, aa_b = ints[8:14]
    sigma2, thresh = reals[0], reals[1]
    blocks = km.table(ints[14:])
    nxt = km.reader(ptrs)
    cov_in = nxt(B * D * D, T).reshape(B, D, D)
    cov_out = nxt(B * D * D, T).reshape(B, D, D)
    lever_in = nxt(B * 3, T).reshape(B, 3)
    masks = km.masks(nxt, B, blocks)
    ranges = nxt(B * A, T).reshape(B, A)
    range_mask = nxt(B * A, np.bool_).reshape(B, A)
    accepted = nxt(B * A, np.bool_).reshape(B, A)
    chi2 = nxt(B * A, T).reshape(B, A)
    outs = km.mean_blocks(nxt, B, blocks, T)
    for b in range(B):
        P = cov_in[b].copy()
        keep = km.keep(masks, b, blocks)
        q, p = outs[q_b][b], outs[p_b][b]
        lever = outs[lever_b][b] if lever_b >= 0 else lever_in[b]
        ap, ag, aa = outs[ap_b][b].reshape(A, 3), outs[ag_b][b], outs[aa_b][b]
        for s in range(A):
            if not (range_mask[b, s] and masks[2][b, s]):
                accepted[b, s], chi2[b, s] = False, 0
                continue
            qv, w = q[:3], q[3]
            sk = np.array([[0, -qv[2], qv[1]], [qv[2], 0, -qv[0]], [-qv[1], qv[0], 0]], T)
            R = (2 * w * w - 1) * np.eye(3, dtype=T) - 2 * w * sk + 2 * np.outer(qv, qv)
            diff = ap[s] - (p - R.T @ lever)
            d = np.sqrt(diff @ diff)
            u = diff / (T(1) if d < 1e-9 else d)
            kk = T(1) + aa[s]
            r = ranges[b, s] - (kk * d + ag[s])
            wv = R @ u
            H = np.zeros(D, T)
            H[theta_off: theta_off + 3] = -kk * np.cross(wv, lever)
            H[p_off: p_off + 3] = -kk * u
            if lever_off >= 0:
                H[lever_off: lever_off + 3] = kk * wv
            a0 = anchor_off + 5 * s
            H[a0: a0 + 5] = [*(kk * u), 1, d]
            pht = P @ H
            S = H @ pht + T(sigma2)
            gamma = r * r / S
            chi2[b, s] = gamma
            accepted[b, s] = ok = float(gamma) < thresh
            if not ok:
                continue
            K = pht / S if S > 0 else np.full(D, np.nan, T)
            P = P - np.outer(K, pht)
            P = T(0.5) * (P + P.T)
            km.inject(outs, b, blocks, keep, K * r)
        cov_out[b] = P
    return 0


# the dynamic shared memory the kernel may take: the block's 227 KB less
# its static part (the block table and the scalars, under 1.5 KB)
MODEL_SMEM_BYTES = 232448 - 1536


def model_shared_bytes(ints):
    """The kernel's dynamic shared memory when it stages the covariance
    (`smem_bytes` in `csrc/uwb_update.cu`): P H^T and K (D each), the
    mean, the ranges and the covariance in values, then a byte a block
    row and a byte a slot."""
    itemsize = 8 if ints[0] else 4
    D, A = ints[2], ints[3]
    blocks = km.table(ints[14:])
    mean = sum(rows * width for _, rows, width, _, _, _ in blocks)
    return (2 * D + mean + A + D * D) * itemsize + sum(rows for _, rows, _, _, _, _ in blocks) + A


def model_shared_memory(ints, staged):
    """`uvio_uwb_shared_memory` as the library answers it."""
    staged[0] = int(model_shared_bytes(ints[:15 + 6 * ints[14]]) <= MODEL_SMEM_BYTES)
    return 0


@pytest.fixture
def modelled_launch(monkeypatch):
    """CPU tensors take the launch path, with `model_entry` and
    `model_shared_memory` as the library."""
    monkeypatch.setattr(launches, "route", lambda *t: True)
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(uvio_uwb_update=model_entry,
                                                                      uvio_uwb_shared_memory=model_shared_memory))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _assert_matches_plain(got, gi, want, wi, tol):
    assert torch.equal(gi["accepted"], wi["accepted"])
    torch.testing.assert_close(gi["chi2"], wi["chi2"], rtol=tol, atol=0)
    for n in FIELDS:
        x, y = getattr(got, n), getattr(want, n)
        if x.dtype.is_floating_point:
            scale = max(float(y.abs().max()), 1.0) if y.numel() else 1.0
            torch.testing.assert_close(x, y, rtol=0, atol=tol * scale, msg=n)
        else:
            assert torch.equal(x, y), n


@pytest.mark.parametrize("name", LAYOUTS)
def test_modelled_launch_matches_the_plain_version(name, modelled_launch):
    L = LAYOUTS[name]
    st = random_state(L, seed=2)
    ranges, mask = ranges_for(st, L)
    before = launches.launch_counts["uwb_update"]
    got, gi = uwb.uwb_update(st, L, ranges, mask, sigma_range=0.1, chi2_mult=1.5)
    assert launches.launch_counts["uwb_update"] == before + 1
    want, wi = uwb.uwb_update_ref(st, L, ranges, mask, sigma_range=0.1, chi2_mult=1.5)
    assert wi["accepted"].sum() >= 1 and not wi["accepted"][0]
    _assert_matches_plain(got, gi, want, wi, 1e-12)
    # FEJ values and the time axis are left as they were
    for n in ("q_fej", "p_fej", "v_fej", "clones_q_fej", "clones_p_fej", "slam_p_fej", "time", "clones_t"):
        assert torch.equal(getattr(got, n), getattr(st, n)), n


def test_modelled_launch_float32(modelled_launch):
    L = LAYOUTS["corridor"]
    st = random_state(L, seed=5, dtype=torch.float32)
    ranges, mask = ranges_for(st, L, seed=5)
    got, gi = uwb.uwb_update(st, L, ranges, mask)
    want, wi = uwb.uwb_update_ref(st, L, ranges, mask)
    assert gi["chi2"].dtype == torch.float32 and got.cov.dtype == torch.float32
    _assert_matches_plain(got, gi, want, wi, 1e-4)


@pytest.mark.parametrize("name", ["corridor", "imu_rpng"])
def test_modelled_launch_under_vmap_is_one_launch(name, modelled_launch):
    """The batch rule: three sequences (different states and ranges, one
    with no range at all) in one launch, each as its own plain update."""
    L = LAYOUTS[name]
    states = [random_state(L, seed=10 + b) for b in range(3)]
    inputs = [ranges_for(s, L, seed=b) for b, s in enumerate(states)]
    inputs[2] = (inputs[2][0], torch.zeros_like(inputs[2][1]))
    batch = FilterState(**{n: torch.stack([getattr(s, n) for s in states]) for n in FIELDS})
    ranges = torch.stack([r for r, _ in inputs])
    masks = torch.stack([m for _, m in inputs])
    before = launches.launch_counts["uwb_update"]
    fields, info = torch.func.vmap(
        lambda f, r, m: (lambda o: (tuple(getattr(o[0], n) for n in FIELDS), o[1]))(
            uwb.uwb_update(FilterState(**dict(zip(FIELDS, f))), L, r, m)))(
        tuple(getattr(batch, n) for n in FIELDS), ranges, masks)
    assert launches.launch_counts["uwb_update"] == before + 1
    for b, (s, (r, m)) in enumerate(zip(states, inputs)):
        want, wi = uwb.uwb_update_ref(s, L, r, m)
        got = FilterState(**{n: f[b] for n, f in zip(FIELDS, fields)})
        _assert_matches_plain(got, {k: v[b] for k, v in info.items()}, want, wi, 1e-12)
    assert not info["accepted"][2].any()


def test_launch_refuses_what_the_kernel_does_not_take(modelled_launch):
    L = LAYOUTS["corridor"]
    st = random_state(L)
    ranges, mask = ranges_for(st, L)
    with pytest.raises(ValueError, match="range_mask"):
        uwb.uwb_update(st, L, ranges, mask[:-1])
    with pytest.raises(TypeError, match="float32 or float64"):
        half = FilterState(**{n: (getattr(st, n).half() if getattr(st, n).dtype == torch.float64
                                  and n not in ("time", "clones_t") else getattr(st, n)) for n in FIELDS})
        uwb.uwb_update(half, L, ranges, mask)
    wide = dataclasses.replace(L, max_anchors=9)
    with pytest.raises(ValueError, match="values"):
        uwb.uwb_update(st, wide, torch.zeros(9, dtype=torch.float64), torch.ones(9, dtype=torch.bool))

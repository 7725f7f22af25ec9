"""Port parity, MSCKF: batched triangulation and the full MSCKF update
on padded tracks of a simulated scene, float64 on the CPU.

QR bases can differ between LAPACK builds by signs and rotations, so the
projected systems are not compared; the invariants are: triangulation
success, chi2 keep mask, number used and covariance health match exactly,
and the updated state and covariance agree to 1e-8."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uvio_tpu.types import StateLayout as JLayout
from uvio_tpu.types import init_state as j_init

from uvio_tpu_torch.types import StateLayout as TLayout
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy

torch.set_num_threads(1)

K, F = 11, 40
INTR = np.array([458.0, 457.0, 367.0, 248.0, -0.28, 0.07, 2e-4, 1.8e-5])


def _scene(seed=0, **calib):
    """Clone poses along an arc, landmarks 3-9 m ahead, radtan pixels
    with 1 px noise, padded tracks of 2..K observations, a few outliers
    and a few features with a single observation."""
    from uvio_tpu.cam import models as cm
    from uvio_tpu.math import exp_so3, rot_to_quat

    rng = np.random.default_rng(seed)
    layout = JLayout(max_clones=K, max_slam=0, **calib)
    # IMU = camera frame; the camera looks along +z and moves along x
    Rs = np.asarray(exp_so3(jnp.asarray(np.stack([np.zeros(K), 0.02 * np.arange(K), np.zeros(K)], 1))))
    ps = np.stack([0.08 * np.arange(K), 0.01 * np.sin(np.arange(K)), np.zeros(K)], 1)
    q = np.asarray(rot_to_quat(jnp.asarray(Rs)))
    P = np.stack([rng.uniform(-3, 3, F), rng.uniform(-2, 2, F), rng.uniform(3, 9, F)], 1)
    p_cam = np.einsum("kij,fkj->fki", Rs, P[:, None, :] - ps[None])
    uv = np.asarray(cm.project(jnp.asarray(INTR), 0, jnp.asarray(p_cam)))
    uv = uv + rng.normal(size=uv.shape)
    uv[:3, 5] += 30.0  # outliers for the chi2 gate
    start = rng.integers(0, K - 2, F)
    length = rng.integers(2, K + 1, F)
    k = np.arange(K)
    mask = (k[None] >= start[:, None]) & (k[None] < start[:, None] + length[:, None])
    mask[-2:] = k[None] == 3  # single observation: no update rows
    D = layout.dim
    cov = np.diag(np.full(D, 1e-4)) + 1e-6
    st = j_init(layout).replace(
        time=jnp.asarray(1.0), q=jnp.asarray(q[-1]), p=jnp.asarray(ps[-1]),
        q_fej=jnp.asarray(q[-1]), p_fej=jnp.asarray(ps[-1]),
        clones_q=jnp.asarray(q), clones_p=jnp.asarray(ps),
        clones_q_fej=jnp.asarray(q), clones_p_fej=jnp.asarray(ps + 1e-4),
        clones_t=jnp.asarray(0.1 * np.arange(K)), clones_valid=jnp.ones(K, bool),
        clone_head=jnp.asarray(K - 1, jnp.int32), calib_cam_intr=jnp.asarray(INTR)[None],
        cov=jnp.asarray(cov),
    )
    return layout, st, uv[:, :, None, :], mask[:, :, None]


def _port(st):
    return state_from_numpy({n: np.asarray(getattr(st, n)) for n in FIELDS}, device="cpu", dtype=torch.float64)


def test_triangulate_batch_matches():
    from uvio_tpu.update.msckf import clone_camera_poses as j_poses
    from uvio_tpu.update.triangulation import triangulate_batch as j_tri
    from uvio_tpu.cam import models as cm

    from uvio_tpu_torch.update.msckf import clone_camera_poses as t_poses
    from uvio_tpu_torch.update.triangulation import triangulate_batch as t_tri

    layout, st, uv, mask = _scene(1)
    uvn = np.array(cm.undistort(jnp.asarray(INTR), 0, jnp.asarray(uv[:, :, 0])))
    (Rj, pj), (Rjf, pjf) = j_poses(st, layout)
    (Rt, pt), (Rtf, ptf) = t_poses(_port(st), TLayout(max_clones=K, max_slam=0))
    for a, b in ((Rj, Rt), (pj, pt), (Rjf, Rtf), (pjf, ptf)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-12)
    R, p = np.array(Rj)[:, 0], np.array(pj)[:, 0]
    pf_j, ok_j = j_tri(jnp.asarray(uvn), jnp.asarray(mask[:, :, 0]), jnp.asarray(R), jnp.asarray(p))
    pf_t, ok_t = t_tri(torch.as_tensor(uvn), torch.as_tensor(mask[:, :, 0]), torch.as_tensor(R),
                       torch.as_tensor(p))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.sum() >= 30
    np.testing.assert_allclose(pf_t.numpy(), np.asarray(pf_j), atol=1e-8)


@pytest.mark.parametrize("calib", [
    {},  # the fused step's layout
    # camera time offset, extrinsics and intrinsics in the error state
    dict(calib_cam_timeoffset=True, calib_cam_pose=True, calib_cam_intrinsics=True),
])
def test_msckf_update_matches(calib):
    from uvio_tpu.update.msckf import msckf_update as j_upd

    from uvio_tpu_torch.update.msckf import msckf_update as t_upd

    layout, st, uv, mask = _scene(2, **calib)
    js, ji = j_upd(st, layout, 0, jnp.asarray(uv), jnp.asarray(mask), sigma_pix=1.0)
    ts, ti = t_upd(_port(st), TLayout(max_clones=K, max_slam=0, **calib), 0, torch.as_tensor(uv),
                   torch.as_tensor(mask), sigma_pix=1.0)
    np.testing.assert_array_equal(ti["tri_ok"].numpy(), np.asarray(ji["tri_ok"]))
    np.testing.assert_array_equal(ti["kept"].numpy(), np.asarray(ji["kept"]))
    assert int(ti["num_used"]) == int(ji["num_used"])
    assert 25 <= int(ti["num_used"]) < F  # outliers and single observations dropped
    assert bool(ti["cov_ok"]) == bool(ji["cov_ok"]) is True
    for n in ("q", "p", "v", "clones_q", "clones_p", "calib_dt", "calib_cam_q", "calib_cam_p",
              "calib_cam_intr", "cov"):
        np.testing.assert_allclose(getattr(ts, n).numpy(), np.asarray(getattr(js, n)), atol=1e-8,
                                   err_msg=n)

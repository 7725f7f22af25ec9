"""Port parity, bundle adjustment: `uvio_tpu_torch.parallel.ba.ba_solve`
against `uvio_tpu`'s unsharded `ba_solve`, float64 on the CPU.

Scenes are `tests/test_ba.py`'s (keyframes on an arc looking at a
landmark cloud, then perturbed): N=12, L=64 and N=24, L=256.

Tolerances: the same Gauss-Newton pieces, Schur complement and Cholesky
solve in both packages, summed in different orders, so the per-iteration
costs and the final poses and landmarks agree to 1e-8 relative; every
accept/reject decision is the same (the cost sequence shows it). Padding
is held exactly: padded landmark rows and the positions of invalid
keyframe slots return their inputs bit for bit (their quaternions up to
the rounding of the renormalization every update applies, 1e-15).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ba import make_scene, perturb, reproj_rmse
from uvio_tpu.parallel.ba import BAOptions as JOpts
from uvio_tpu.parallel.ba import ba_solve as j_solve

from uvio_tpu_torch.parallel.ba import BAOptions, _inv3, ba_solve

torch.set_num_threads(1)
T64 = torch.float64


def _t(a, dtype=T64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close_rel(got, ref, rtol, what):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= rtol * max(1.0, np.abs(ref).max()), (what, err)


def _both(q0, p0, lm0, obs, mask, iters, pose_valid=None):
    j = j_solve(jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(lm0), jnp.asarray(obs), jnp.asarray(mask),
                JOpts(iters=iters), pose_valid=None if pose_valid is None else jnp.asarray(pose_valid))
    t = ba_solve(_t(q0), _t(p0), _t(lm0), _t(obs), _t(mask, torch.bool), BAOptions(iters=iters),
                 pose_valid=None if pose_valid is None else _t(pose_valid, torch.bool))
    return j, t


def _check(j, t, rtol=1e-8):
    np.testing.assert_allclose(t[3]["costs"].numpy(), np.asarray(j[3]["costs"]), rtol=rtol, atol=0)
    for k, name in enumerate(("q", "p", "lm")):
        _close_rel(t[k].numpy(), j[k], rtol, name)


@pytest.mark.parametrize("N,L,iters", [(12, 64, 15), (24, 256, 10)])
def test_ba_solve_matches_reference(N, L, iters):
    q, p, lm, obs, mask = make_scene(N=N, L=L)
    q0, p0, lm0 = perturb(q, p, lm)
    j, t = _both(q0, p0, lm0, obs, mask, iters)
    _check(j, t)
    costs = t[3]["costs"].numpy()
    assert costs.shape == (iters,) and costs[-1] < 0.05 * costs[0]
    assert reproj_rmse(t[0].numpy(), t[1].numpy(), t[2].numpy(), obs, mask) < 0.05 * reproj_rmse(q0, p0, lm0, obs, mask)
    # the gauge: the first keyframe is held
    np.testing.assert_array_equal(t[0][0].numpy(), q0[0])
    np.testing.assert_array_equal(t[1][0].numpy(), p0[0])


def test_ba_converges_to_the_scene():
    """`tests/test_ba.py::test_ba_converges`'s gates on the port."""
    q, p, lm, obs, mask = make_scene()
    q0, p0, lm0 = perturb(q, p, lm)
    qs, ps, lms, _ = ba_solve(_t(q0), _t(p0), _t(lm0), _t(obs), _t(mask, torch.bool), BAOptions(iters=15))
    assert reproj_rmse(qs.numpy(), ps.numpy(), lms.numpy(), obs, mask) < 0.05 * reproj_rmse(q0, p0, lm0, obs, mask)
    assert np.linalg.norm(ps.numpy() - p, axis=1).max() < 0.02


def test_landmark_padding_is_inert():
    """`tests/test_ba.py::test_ba_masked_padding_inert`: 16 all-masked
    landmark rows change nothing, and come back exactly as they went in."""
    q, p, lm, obs, mask = make_scene(L=48)
    q0, p0, lm0 = perturb(q, p, lm)
    pad = 16
    lm_pad = np.random.default_rng(0).uniform(-1, 1, (pad, 3))  # not zeros: any value stays put
    lm0_p = np.concatenate([lm0, lm_pad])
    obs_p = np.concatenate([obs, np.zeros((pad,) + obs.shape[1:])])
    mask_p = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], bool)])
    j, t = _both(q0, p0, lm0_p, obs_p, mask_p, 6)
    _check(j, t)
    np.testing.assert_array_equal(t[2][48:].numpy(), lm_pad)
    a = ba_solve(_t(q0), _t(p0), _t(lm0), _t(obs), _t(mask, torch.bool), BAOptions(iters=6))
    np.testing.assert_allclose(t[1].numpy(), a[1].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t[2][:48].numpy(), a[2].numpy(), rtol=0, atol=1e-9)


def test_pose_valid_padding_is_inert():
    """`tests/test_map_backend.py::test_ba_pose_valid_padding_inert`: 6
    invalid keyframe slots reproduce the unpadded solve on the live slots
    and return their own inputs exactly."""
    q, p, lm, obs, mask = make_scene(N=10, L=48)
    q0, p0, lm0 = perturb(q, p, lm)
    pad = 6
    rng = np.random.default_rng(1)
    q_pad = rng.standard_normal((pad, 4))
    q_pad /= np.linalg.norm(q_pad, axis=1, keepdims=True)
    q_pad *= np.sign(q_pad[:, 3:])  # the JPL w >= 0 convention every update re-imposes
    p_pad = rng.standard_normal((pad, 3))
    qp, pp = np.concatenate([q0, q_pad]), np.concatenate([p0, p_pad])
    obs_p = np.concatenate([obs, np.zeros(obs.shape[:1] + (pad, 2))], axis=1)
    mask_p = np.concatenate([mask, np.zeros(mask.shape[:1] + (pad,), bool)], axis=1)
    valid = np.concatenate([np.ones(len(q0), bool), np.zeros(pad, bool)])
    j, t = _both(qp, pp, lm0, obs_p, mask_p, 6, pose_valid=valid)
    _check(j, t)
    np.testing.assert_array_equal(t[1][10:].numpy(), p_pad)
    # (a zero update renormalizes the quaternion: equal up to its rounding)
    np.testing.assert_allclose(t[0][10:].numpy(), q_pad, rtol=0, atol=1e-15)
    a = ba_solve(_t(q0), _t(p0), _t(lm0), _t(obs), _t(mask, torch.bool), BAOptions(iters=6))
    np.testing.assert_allclose(t[1][:10].numpy(), a[1].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(t[2].numpy(), a[2].numpy(), rtol=0, atol=1e-9)


def test_inv3_matches_and_guards_singular_blocks():
    from uvio_tpu.parallel.ba import _inv3 as j_inv3

    rng = np.random.default_rng(2)
    A = rng.standard_normal((20, 3, 3))
    A[:5] = 0.0  # a masked landmark's block
    A[5] = np.outer([1.0, 2, 3], [1.0, 2, 3])  # rank one
    got = _inv3(_t(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_inv3(jnp.asarray(A))), rtol=1e-12, atol=1e-12)
    assert np.isfinite(got).all() and (got[:5] == 0).all()
    np.testing.assert_allclose(got[6:] @ A[6:], np.broadcast_to(np.eye(3), (14, 3, 3)), atol=1e-9)

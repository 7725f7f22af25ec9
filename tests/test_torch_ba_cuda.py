"""The bundle adjustment on the card: `ba_solve` on cuda:0 against the
same solve on the CPU, and its Levenberg loop with no host sync. Skips
without a CUDA device.

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_ba_cuda.py

Tolerances: the same float64 arithmetic on two devices, summed in
different orders: per-iteration costs to 1e-9 relative, final
parameters to 1e-8.
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.math import rot_to_quat
from uvio_tpu_torch.parallel.ba import BAOptions, ba_solve

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _scene(N, L, seed=3):
    """`tests/test_ba.py`'s scene (keyframes on an arc looking at a
    landmark cloud, 0.5 px noise), perturbed: (q0, p0, lm0, obs, mask)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 1.2, N)
    p = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * th], axis=1)
    lm = rng.uniform(-1.5, 1.5, (L, 3))
    z = -p / np.linalg.norm(p, axis=1, keepdims=True)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=1)  # R_GtoC
    pc = np.einsum("nij,lnj->lni", R, lm[:, None] - p[None])
    obs = pc[..., :2] / pc[..., 2:3] + (0.5 / 450.0) * rng.standard_normal((L, N, 2))
    mask = (pc[..., 2] > 0.5) & (np.abs(obs) < 0.9).all(-1)
    dR = Rotation.from_rotvec(0.02 * rng.standard_normal((N, 3))).as_matrix()
    dR[0] = np.eye(3)  # the gauge keyframe stays exact
    q0 = rot_to_quat(torch.as_tensor(dR @ R)).numpy()
    p0 = p + np.concatenate([np.zeros((1, 3)), 0.05 * rng.standard_normal((N - 1, 3))])
    return q0, p0, lm + 0.1 * rng.standard_normal(lm.shape), obs, mask


def _solve(dev, q0, p0, lm0, obs, mask, iters):
    t = lambda a, dtype=torch.float64: torch.as_tensor(a, dtype=dtype, device=dev)
    return ba_solve(t(q0), t(p0), t(lm0), t(obs), t(mask, torch.bool), BAOptions(iters=iters))


def test_ba_card_matches_cpu(dev):
    q0, p0, lm0, obs, mask = _scene(24, 256)
    a = _solve(dev, q0, p0, lm0, obs, mask, 10)
    b = _solve("cpu", q0, p0, lm0, obs, mask, 10)
    np.testing.assert_allclose(a[3]["costs"].cpu().numpy(), b[3]["costs"].numpy(), rtol=1e-9, atol=0)
    for k in range(3):
        np.testing.assert_allclose(a[k].cpu().numpy(), b[k].numpy(), rtol=0, atol=1e-8)
    costs = b[3]["costs"].numpy()
    assert costs[-1] < 0.05 * costs[0]


def test_ba_loop_has_no_host_sync(dev):
    q0, p0, lm0, obs, mask = _scene(12, 64)
    t = lambda a, dtype=torch.float64: torch.as_tensor(a, dtype=dtype, device=dev)
    args = (t(q0), t(p0), t(lm0), t(obs), t(mask, torch.bool))
    ba_solve(*args, BAOptions(iters=2))  # first use of the solver libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ba_solve(*args, BAOptions(iters=8))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[3]["costs"].shape == (8,) and bool(torch.isfinite(out[2]).all())

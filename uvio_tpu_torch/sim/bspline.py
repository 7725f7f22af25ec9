"""Cubic SE(3) B-spline for trajectory simulation (float64).

Port of `uvio_tpu/sim/bspline.py` (the reference's
`ov_core/src/sim/BsplineSE3`): a uniform cubic B-spline over SE(3)
control poses,

    T(u) = T_i0 * exp(b0(u) Omega_1) * exp(b1(u) Omega_2) * exp(b2(u) Omega_3)

with Omega_k = log(T_{k-1}^{-1} T_k) and the cumulative cubic basis
b0 = (5 + 3u - 3u^2 + u^3)/6, b1 = (1 + 3u + 3u^2 - 2u^3)/6, b2 = u^3/6.

`uvio_tpu` differentiates the pose function with `jax.jacfwd`; here the
derivatives are closed form. `exp_se3` is the matrix exponential of the
twist's hat, so d/du exp(b Ω^) = exp(b Ω^) Ω^ b'(u) and the product
rule gives velocity and acceleration exactly. The control-pose log
terms are piecewise constant in t and are computed once per query
(`bspline.py:81-86`). Queries are batched over a 1-D time tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import exp_se3, hat_se3, inv_se3, log_se3, quat_to_rot

_F64 = torch.float64


def build_controls(times: np.ndarray, q_GtoI: np.ndarray, p_IinG: np.ndarray):
    """Control poses from trajectory samples (feed_trajectory behavior):
    the poses themselves, uniformly spaced at the mean sample spacing.
    Returns (t0, dt, T_controls (N,4,4) float64 as T_ItoG)."""
    dt = float(np.mean(np.diff(times)))
    R_GtoI = quat_to_rot(torch.as_tensor(q_GtoI, dtype=_F64))
    T = torch.zeros((len(times), 4, 4), dtype=_F64)
    T[:, :3, :3] = R_GtoI.transpose(-1, -2)
    T[:, :3, 3] = torch.as_tensor(p_IinG, dtype=_F64)
    T[:, 3, 3] = 1.0
    return float(times[0]), dt, T


def _basis(u):
    """(b, b', b'') of the cumulative cubic basis, each (..., 3)."""
    b = torch.stack([(5.0 + 3.0 * u - 3.0 * u * u + u**3) / 6.0,
                     (1.0 + 3.0 * u + 3.0 * u * u - 2.0 * u**3) / 6.0,
                     u**3 / 6.0], dim=-1)
    db = torch.stack([(3.0 - 6.0 * u + 3.0 * u * u) / 6.0,
                      (3.0 + 6.0 * u - 6.0 * u * u) / 6.0,
                      0.5 * u * u], dim=-1)
    ddb = torch.stack([(-6.0 + 6.0 * u) / 6.0, (6.0 - 12.0 * u) / 6.0, u], dim=-1)
    return b, db, ddb


def state_at(controls: torch.Tensor, t0: float, dt: float, t: torch.Tensor):
    """Kinematic state at times t (B,): dict of R_GtoI (B,3,3), p_IinG,
    v_IinG, a_IinG (B,3) and w_IinI (B,3), the angular velocity in the
    IMU frame."""
    n = controls.shape[0]
    t = torch.as_tensor(t, dtype=_F64)
    s0 = (t - t0) / dt
    i1 = torch.clamp(torch.floor(s0).long(), 1, n - 3)
    Ts = [controls[i1 + k] for k in (-1, 0, 1, 2)]
    T0 = Ts[0]
    w = [log_se3(inv_se3(Ts[k]) @ Ts[k + 1]) for k in range(3)]  # Omega_1..3
    u = (t - t0) / dt - i1.to(_F64)
    b, db, ddb = _basis(u)
    A, dA, ddA = [], [], []
    for k in range(3):
        W = hat_se3(w[k])
        Ak = exp_se3(b[:, k, None] * w[k])
        bk1 = db[:, k, None, None]
        bk2 = ddb[:, k, None, None]
        A.append(Ak)
        dA.append(Ak @ W * bk1)
        ddA.append(Ak @ (W @ W) * bk1 * bk1 + Ak @ W * bk2)
    T = T0 @ A[0] @ A[1] @ A[2]
    dT = T0 @ (dA[0] @ A[1] @ A[2] + A[0] @ dA[1] @ A[2] + A[0] @ A[1] @ dA[2]) / dt
    ddT = T0 @ (
        ddA[0] @ A[1] @ A[2] + A[0] @ ddA[1] @ A[2] + A[0] @ A[1] @ ddA[2]
        + 2.0 * (dA[0] @ dA[1] @ A[2] + dA[0] @ A[1] @ dA[2] + A[0] @ dA[1] @ dA[2])
    ) / (dt * dt)
    R_ItoG = T[:, :3, :3]
    Wm = R_ItoG.transpose(-1, -2) @ dT[:, :3, :3]  # [w]_x
    return {
        "R_GtoI": R_ItoG.transpose(-1, -2),
        "p_IinG": T[:, :3, 3],
        "v_IinG": dT[:, :3, 3],
        "a_IinG": ddT[:, :3, 3],
        "w_IinI": torch.stack([Wm[:, 2, 1], Wm[:, 0, 2], Wm[:, 1, 0]], dim=-1),
    }

"""IMU preintegration for initialization.

Port of `uvio_tpu/init/cpi.py` (the reference's continuous
preintegration, `ov_core/src/cpi/CpiBase.h` / `CpiV1` / `CpiV2`):
relative rotation, velocity (beta) and position (alpha) preintegrals
between two times in the start frame,

    R_k2tau,  beta = int R_k2t a dt,  alpha = int int R_k2t a dt^2

so that with gravity g and start state (R_GtoIk, p_k, v_k):

    p_tau = p_k + v_k dt - 0.5 g dt^2 + R_GtoIk^T alpha
    v_tau = v_k - g dt + R_GtoIk^T beta

Each `lax.scan` of the reference over the M-1 sample pairs is a Python
loop over samples here, with any number of intervals as leading batch
dimensions (the dynamic initializer integrates its P-1 intervals in one
pass, where the reference `vmap`s). Everything that does not depend on
the running rotation (rates, increments, the per-pair exponentials and
closed-form argument matrices) is computed for all pairs at once before
the loop, so a loop step is a dozen small launches. A padded pair
(dt == 0) is an exact identity step: its dt is zeroed, so it adds zeros
and multiplies by the identity, which is what the reference's
`where(dt > 0, ...)` keeps.

The functions stay differentiable in `bg`/`ba` (and the IMU data): the
dynamic initializer takes forward-mode Jacobians through them
(`torch.func.jacfwd`), so every tangent must stay finite, including at a
zero rate, where a plain `norm` has no derivative: the angle is taken as
the square root of a guarded squared norm, and `exp_so3` is the port's
Taylor-branch one.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..math import exp_so3, skew

_SMALL_ANGLE_RATE = 0.008726646  # rad/s: below it the Taylor forms (`CpiV1.cpp:76-121`)


def active_pairs(imu_t: torch.Tensor) -> int:
    """Number of leading sample pairs that hold any positive dt over all
    leading batch rows: the pairs after it are padding, identity steps
    that the loops may skip. One read-back to the host."""
    dt = imu_t[..., 1:] - imu_t[..., :-1]
    has = (dt > 0).reshape(-1, dt.shape[-1]).any(0)
    idx = torch.nonzero(has)
    return int(idx[-1].item()) + 1 if idx.numel() else 0


def _pairs(imu_t, imu_w, imu_a, dtype, n_pairs):
    """Per-pair (dt, w1, a1, w2, a2) for the first n_pairs pairs, dt
    zeroed where it is not positive."""
    n = imu_t.shape[-1] - 1 if n_pairs is None else n_pairs
    dt = (imu_t[..., 1 : n + 1] - imu_t[..., :n]).to(dtype)
    dt = torch.where(dt > 0, dt, torch.zeros_like(dt))
    return n, dt, imu_w[..., :n, :], imu_a[..., :n, :], imu_w[..., 1 : n + 1, :], imu_a[..., 1 : n + 1, :]


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _mtv(R, v):
    return (R.transpose(-1, -2) @ v[..., None])[..., 0]


def _start(like, batch):
    """Identity rotation and zero alpha/beta for `batch` intervals."""
    R = torch.eye(3, dtype=like.dtype, device=like.device).expand(*batch, 3, 3)
    z = torch.zeros((*batch, 3), dtype=like.dtype, device=like.device)
    return R, z, z


def _result(imu_t, R, alpha, beta, dtype):
    return {"R_k2tau": R, "alpha": alpha, "beta": beta, "dt": (imu_t[..., -1] - imu_t[..., 0]).to(dtype)}


def preintegrate(imu_t, imu_w, imu_a, bg, ba, n_pairs: Optional[int] = None):
    """Midpoint preintegration of padded IMU slices imu_t (...,M),
    imu_w/imu_a (...,M,3); bg/ba (3,) or (...,3).

    Returns a dict with R_k2tau (...,3,3) (rotation start -> end frame),
    alpha (...,3), beta (...,3), dt (...). Padded samples (dt == 0) are
    identity. `n_pairs` integrates only the first pairs (the rest must
    be padding, see `active_pairs`)."""
    dtype = imu_w.dtype
    batch = imu_t.shape[:-1]
    n, dt, w1, a1, w2, a2 = _pairs(imu_t, imu_w, imu_a, dtype, n_pairs)
    w_hat = 0.5 * (w1 + w2) - bg[..., None, :]
    a_hat = 0.5 * (a1 + a2) - ba[..., None, :]
    R_step = exp_so3(-w_hat * dt[..., None])  # (...,n,3,3)
    R, alpha, beta = _start(imu_w, batch)
    for k in range(n):
        dk, ak = dt[..., k, None], a_hat[..., k, :]
        a_start0 = _mtv(R, ak)  # accel rotated into the start frame (begin)
        R = R_step[..., k, :, :] @ R
        a_mid = 0.5 * (a_start0 + _mtv(R, ak))
        alpha = alpha + beta * dk + 0.5 * a_mid * dk * dk
        beta = beta + a_mid * dk
    return _result(imu_t, R, alpha, beta, dtype)


def _rot_and_args(w_hat, dt):
    """Closed-form relative rotation and alpha/beta argument matrices of
    each interval (`CpiV1.cpp:76-121` == `CpiV2.cpp:84-119`); w_hat
    (...,3), dt (...)."""
    eye = torch.eye(3, dtype=w_hat.dtype, device=w_hat.device)
    wx = skew(w_hat)
    wx2 = wx @ wx
    t2 = (w_hat * w_hat).sum(-1)
    nz = t2 > 0
    # |w| with a finite derivative at w = 0 (`norm` has none there)
    mag = torch.where(nz, torch.sqrt(torch.where(nz, t2, torch.ones_like(t2))), torch.zeros_like(t2))
    small = mag < _SMALL_ANGLE_RATE
    safe = torch.where(small, torch.ones_like(mag), mag)
    wdt = mag * dt
    s, c = torch.sin(wdt), torch.cos(wdt)
    m = lambda x: x[..., None, None]
    R_rel = torch.where(
        m(small),
        eye - m(dt) * wx + m(dt * dt / 2.0) * wx2,
        eye - m(s / safe) * wx + m((1.0 - c) / safe**2) * wx2,
    )
    f1 = torch.where(small, -(dt**3) / 3.0, (wdt * c - s) / safe**3)
    f2 = torch.where(small, (dt**4) / 8.0, (wdt**2 - 2.0 * c - 2.0 * wdt * s + 2.0) / (2.0 * safe**4))
    f3 = torch.where(small, -(dt * dt) / 2.0, -(1.0 - c) / safe**2)
    f4 = torch.where(small, (dt**3) / 6.0, (wdt - s) / safe**3)
    alpha_arg = m(dt * dt / 2.0) * eye + m(f1) * wx + m(f2) * wx2
    beta_arg = m(dt) * eye + m(f3) * wx + m(f4) * wx2
    return R_rel, alpha_arg, beta_arg


def preintegrate_v1(imu_t, imu_w, imu_a, bg, ba, imu_avg=True, n_pairs: Optional[int] = None):
    """CpiV1 closed-form preintegration (`CpiV1.cpp:33-135`).

    Same contract as `preintegrate` (alpha/beta exclude gravity; the
    shooting equation subtracts 0.5 g dt^2 / g dt), but each interval's
    increment is the exact integral under piecewise-constant w/a."""
    dtype = imu_w.dtype
    batch = imu_t.shape[:-1]
    n, dt, w1, a1, w2, a2 = _pairs(imu_t, imu_w, imu_a, dtype, n_pairs)
    w_hat = (0.5 * (w1 + w2) if imu_avg else w1) - bg[..., None, :]
    a_hat = (0.5 * (a1 + a2) if imu_avg else a1) - ba[..., None, :]
    R_rel, Aarg, Barg = _rot_and_args(w_hat, dt)
    Aa, Ba = _mv(Aarg, a_hat), _mv(Barg, a_hat)
    R, alpha, beta = _start(imu_w, batch)
    for k in range(n):
        R = R_rel[..., k, :, :] @ R
        alpha = alpha + beta * dt[..., k, None] + _mtv(R, Aa[..., k, :])
        beta = beta + _mtv(R, Ba[..., k, :])
    return _result(imu_t, R, alpha, beta, dtype)


def preintegrate_v2(
    imu_t, imu_w, imu_a, bg, ba, R_GtoIk_lin, gravity, imu_avg=True, n_pairs: Optional[int] = None
):
    """CpiV2 closed-form preintegration (`CpiV2.cpp:30-130`): the
    piecewise-constant quantity is the LOCAL gravity-compensated
    acceleration a_m - ba - R_k2tau R_GtoIk_lin g, so gravity is inside
    the integral and the shooting equations have no explicit g terms:

        p_tau = p_k + v_k dt + R_GtoIk^T alpha
        v_tau = v_k + R_GtoIk^T beta

    `R_GtoIk_lin` (3,3) is the linearization orientation at the window
    start, `gravity` (3,) the global gravity vector."""
    dtype = imu_w.dtype
    batch = imu_t.shape[:-1]
    g_k = _mv(R_GtoIk_lin, gravity).to(dtype)
    n, dt, w1, a1, w2, a2 = _pairs(imu_t, imu_w, imu_a, dtype, n_pairs)
    w_hat = (0.5 * (w1 + w2) if imu_avg else w1) - bg[..., None, :]
    R_rel, Aarg, Barg = _rot_and_args(w_hat, dt)
    R, alpha, beta = _start(imu_w, batch)
    for k in range(n):
        R_new = R_rel[..., k, :, :] @ R
        a_hat = a1[..., k, :] - ba - _mv(R, g_k)
        if imu_avg:
            # the reference averages the LOCAL acceleration after the
            # relative rotation is known (`CpiV2.cpp:92-96`)
            a_hat = 0.5 * (a_hat + a2[..., k, :] - ba - _mv(R_new, g_k))
        alpha = alpha + beta * dt[..., k, None] + _mtv(R_new, _mv(Aarg[..., k, :, :], a_hat))
        beta = beta + _mtv(R_new, _mv(Barg[..., k, :, :], a_hat))
        R = R_new
    return _result(imu_t, R, alpha, beta, dtype)

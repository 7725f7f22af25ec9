"""Zero-velocity update (ZUPT).

Port of `uvio_tpu/update/zupt.py` (the reference's
`ov_msckf/src/update/UpdaterZeroVelocity.{h,cpp}`): per IMU sample of the
padded window, the residuals

    r_w = w_m - bg              (the gyro says: not rotating)
    r_a = a_m - ba - R_GtoI g   (the accelerometer says: only gravity)

with Jacobians into [theta, bg, ba], whitened, QR-compressed to those 9
columns, gated by chi2 and a velocity-norm test, and applied when both
pass. Every accept decision is a select over both outcomes.
"""

from __future__ import annotations

import torch

from ..filter.ekf import cholesky_or_nan, ekf_update
from ..filter.propagator import NoiseManager, propagate_mean_cov
from ..math import log_so3, quat_to_rot, skew
from ..math.chi2 import chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState, take, where_state


def _blocks9(L: StateLayout, X):
    """The [theta, bg, ba] columns of X, in that order."""
    return torch.cat([X[:, L.theta_off : L.theta_off + 3], X[:, L.bg_off : L.bg_off + 3],
                      X[:, L.ba_off : L.ba_off + 3]], dim=1)


def _inertial_system(state, layout, imu_t, imu_w, imu_a, noises, gravity_mag, noise_mult):
    """Stacked zero-motion inertial residual system over the padded IMU
    window. Returns (Hm, rm, r_diag, rmask, dt_sum)."""
    L = layout
    dtype, device = state.cov.dtype, state.cov.device
    imu_w = imu_w.to(dtype)
    imu_a = imu_a.to(dtype)
    M = imu_t.shape[0]
    dts = imu_t[1:] - imu_t[:-1]  # float64
    valid = dts > 0
    n_step = valid.sum()
    dt_sum = torch.where(valid, dts, torch.zeros_like(dts)).sum()
    dt_avg = dt_sum / torch.clamp(n_step, min=1)

    gravity = gravity_mag * (torch.arange(3, device=device) == 2).to(dtype)
    # residual at the CURRENT attitude; only the Jacobian takes the FEJ
    # attitude (`uvio_tpu/update/zupt.py:45-50`)
    Rg = quat_to_rot(state.q) @ gravity
    Rg_fej = quat_to_rot(state.q_fej) @ gravity
    r_w = imu_w - state.bg[None, :]
    r_a = imu_a - state.ba[None, :] - Rg[None, :]
    smask = torch.cat([torch.ones((1,), dtype=torch.bool, device=device), valid])

    eye3 = torch.eye(3, dtype=dtype, device=device)
    H_one = torch.zeros((6, L.dim), dtype=dtype, device=device)
    H_one[3:6, L.theta_off : L.theta_off + 3] = skew(Rg_fej)
    H_one[0:3, L.bg_off : L.bg_off + 3] = eye3
    H_one[3:6, L.ba_off : L.ba_off + 3] = eye3
    H = H_one.repeat(M, 1)  # (6M, D)
    res = torch.cat([r_w, r_a], dim=1).reshape(-1)
    safe_dt = torch.where(dt_avg > 0, dt_avg, torch.ones_like(dt_avg))
    sig_w2 = (noise_mult * noises.sigma_w**2 / safe_dt).to(dtype)
    sig_a2 = (noise_mult * noises.sigma_a**2 / safe_dt).to(dtype)
    r_diag = torch.cat([sig_w2.expand(3), sig_a2.expand(3)]).repeat(M)
    rmask = smask.repeat_interleave(6)
    return H * rmask[:, None], res * rmask, r_diag, rmask, dt_sum


def _compress(layout, Hm, rm, r_diag, rmask, noise_mult):
    """Whiten and QR-compress the stacked system to its 9 structural
    columns [theta, bg, ba] (`measurement_compress_inplace` before the
    chi2, UpdaterZeroVelocity.cpp:186-193). Returns (Hc (9,D), rc (9,));
    the compressed noise is noise_mult * I9."""
    L = layout
    w = torch.where(rmask, 1.0 / torch.sqrt(r_diag / noise_mult), torch.zeros_like(r_diag))
    Q9, R9 = torch.linalg.qr(_blocks9(L, Hm * w[:, None]), mode="reduced")  # (6M,9),(9,9)
    rc = Q9.T @ (rm * w)
    Hc = torch.zeros((9, L.dim), dtype=Hm.dtype, device=Hm.device)
    Hc[:, L.theta_off : L.theta_off + 3] = R9[:, 0:3]
    Hc[:, L.bg_off : L.bg_off + 3] = R9[:, 3:6]
    Hc[:, L.ba_off : L.ba_off + 3] = R9[:, 6:9]
    return Hc, rc


def _bias_inflated_cov(state, layout, noises, dt_sum):
    """Covariance plus the bias random walk over the window
    (`model_time_varying_bias`, UpdaterZeroVelocity.cpp:195-204, 268-276)."""
    L = layout
    dtype = state.cov.dtype
    q = torch.zeros((L.dim,), dtype=dtype, device=state.cov.device)
    q[L.bg_off : L.bg_off + 3] = (dt_sum * noises.sigma_wb**2).to(dtype)
    q[L.ba_off : L.ba_off + 3] = (dt_sum * noises.sigma_ab**2).to(dtype)
    return state.cov + torch.diag(q)


def _compressed_gate(state, L, imu_t, imu_w, imu_a, noises, gravity_mag, chi2_mult, noise_mult,
                     max_velocity):
    """The chi2 (9 dof, against the bias-inflated covariance) and
    velocity-norm gate both variants share. Returns (accept, chi2, Hc, rc,
    rc_diag, dt_sum) of the compressed system."""
    Hm, rm, r_diag, rmask, dt_sum = _inertial_system(
        state, L, imu_t, imu_w, imu_a, noises, gravity_mag, noise_mult
    )
    Hc, rc = _compress(L, Hm, rm, r_diag, rmask, noise_mult)
    dtype, device = state.cov.dtype, state.cov.device
    rc_diag = torch.full((9,), noise_mult, dtype=dtype, device=device)
    cov = _bias_inflated_cov(state, L, noises, dt_sum)
    S = Hc @ (cov @ Hc.T) + torch.diag(rc_diag)
    gamma = rc @ torch.cholesky_solve(rc[:, None], cholesky_or_nan(0.5 * (S + S.T)))[:, 0]
    nine = torch.full((), 9, dtype=torch.int64, device=device)
    accept = (gamma < chi2_mult * chi2_95(nine, max_dof=9)) & (
        torch.linalg.vector_norm(state.v) < max_velocity
    )
    return accept, gamma, Hc, rc, rc_diag, dt_sum


def _inertial_accept(st, L, noises, Hc, rc, rc_diag, dt_sum, imu_t, stamp_time):
    """The accept path: bias random-walk propagation (the reference's
    EKFPropagation(Phi=I, Q_bias)), then the compressed update."""
    st = st.replace(cov=_bias_inflated_cov(st, L, noises, dt_sum))
    new, _ = ekf_update(st, L, Hc, rc, rc_diag, torch.ones((9,), dtype=torch.bool, device=rc.device))
    return new.replace(time=imu_t[-1] if stamp_time is None else stamp_time)


def zupt_try_update(
    state: FilterState,
    layout: StateLayout,
    imu_t: torch.Tensor,
    imu_w: torch.Tensor,
    imu_a: torch.Tensor,
    noises: NoiseManager,
    gravity_mag: float,
    chi2_mult: float = 1.0,
    noise_mult: float = 10.0,
    max_velocity: float = 0.1,
    stamp_time: torch.Tensor = None,
):
    """Returns (new_state, accepted, chi2). The update applies only when
    the chi2 and velocity gates pass; `stamp_time` (camera clock) is
    stored as the state time on accept."""
    accept, gamma, Hc, rc, rc_diag, dt_sum = _compressed_gate(
        state, layout, imu_t, imu_w, imu_a, noises, gravity_mag, chi2_mult, noise_mult, max_velocity
    )
    new = _inertial_accept(state, layout, noises, Hc, rc, rc_diag, dt_sum, imu_t, stamp_time)
    return where_state(accept, new, state), accept, gamma


def zupt_explicit_update(
    state: FilterState,
    layout: StateLayout,
    imu_t: torch.Tensor,
    imu_w: torch.Tensor,
    imu_a: torch.Tensor,
    noises: NoiseManager,
    gravity_mag: float,
    chi2_mult: float = 1.0,
    noise_mult: float = 10.0,
    max_velocity: float = 0.1,
    stamp_time: torch.Tensor = None,
    integration: str = "rk4",
):
    """Explicit zero-motion variant (`explicitly_enforce_zero_motion`,
    `UpdaterZeroVelocity.cpp:283-330`): gated like `zupt_try_update`; on
    accept it propagates mean and covariance through the window and
    constrains the propagated IMU pose to the newest clone with the 9-dof
    pseudo-measurement [log(R_I R_c^T); p_I - p_c; v] = 0. Without a
    clone it falls back to the inertial update. Returns (new_state,
    accepted, chi2)."""
    L = layout
    dtype, device = state.cov.dtype, state.cov.device
    accept, gamma, Hc, rc, rc_diag, dt_sum = _compressed_gate(
        state, L, imu_t, imu_w, imu_a, noises, gravity_mag, chi2_mult, noise_mult, max_velocity
    )

    # with a clone: propagate, then the clone-pair constraint
    st, _ = propagate_mean_cov(
        state, L, imu_t, imu_w, imu_a, noises, gravity_mag,
        integration=integration, stamp_time=stamp_time,
    )
    # clone_head is -1 only without a clone, where this branch is not
    # selected; the clamp keeps the gather in range (`zupt.py:231`)
    slot = torch.clamp(st.clone_head, min=0)
    R_I = quat_to_rot(st.q)
    R_c = quat_to_rot(take(st.clones_q, slot))
    res = torch.cat([-log_so3(R_I @ R_c.T), -(st.p - take(st.clones_p, slot)), -st.v])
    # Jacobians at FEJ (error convention R = (I - [th]x) R_hat)
    D_hat = quat_to_rot(st.q_fej) @ quat_to_rot(take(st.clones_q_fej, slot)).T
    eye3 = torch.eye(3, dtype=dtype, device=device)
    H = torch.zeros((9, L.dim), dtype=dtype, device=device)
    H[0:3, L.theta_off : L.theta_off + 3] = -eye3
    H[3:6, L.p_off : L.p_off + 3] = eye3
    H[6:9, L.v_off : L.v_off + 3] = eye3
    z3 = torch.zeros_like(eye3)
    clone_cols = torch.cat([torch.cat([D_hat, z3], 1), torch.cat([z3, -eye3], 1),
                            torch.cat([z3, z3], 1)], 0)  # (9,6)
    H = H.index_copy(1, L.clone_off + 6 * slot + torch.arange(6, device=device), clone_cols)
    # the reference's fixed pseudo-noise (ori, pos, vel)
    r9 = torch.cat([torch.full((3,), 1e-2**2, dtype=dtype, device=device),
                    torch.full((6,), 1e-1**2, dtype=dtype, device=device)])
    explicit, _ = ekf_update(st, L, H, res, r9, torch.ones((9,), dtype=torch.bool, device=device))

    inertial = _inertial_accept(state, L, noises, Hc, rc, rc_diag, dt_sum, imu_t, stamp_time)
    new = where_state(state.clone_head >= 0, explicit, inertial)
    return where_state(accept, new, state), accept, gamma

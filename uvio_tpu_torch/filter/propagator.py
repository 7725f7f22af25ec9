"""IMU propagation over a padded IMU window (RK4 mean, ACI² F/G).

Port of the rk4 path of `uvio_tpu/filter/propagator.py` (the reference's
`ov_msckf/src/state/Propagator.{h,cpp}`), batched over the intervals of
one window:

  * pass 0 corrects the readings with the IMU intrinsics (identity
    unless seeded) and biases;
  * pass 1 integrates the mean: each interval's RK4 rotation increment
    and body-frame integrals depend only on the readings, so the
    sequential part is one quaternion prefix product (a log-depth
    doubling loop over the static window length) and two cumsums;
  * pass 2 builds every interval's F/G with the closed-form ACI²
    integrals (`compute_F_and_G_analytic`, which the reference also uses
    for rk4);
  * pass 3 composes (Phi, Qd) pairwise in a log-depth tree.

Padded samples carry dt=0 and contribute exactly F=I, Qd=0. Error
order within the 15-dof IMU block: theta p v bg ba.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..math import jr_so3, omega, quat_multiply, quat_norm, quat_to_rot, skew
from ..types.layout import IMU_MODEL_KALIBR, StateLayout
from ..types.state import FilterState
from .ekf import augment_clone, propagate_covariance

INTEGRATION_RK4 = "rk4"


def dm_matrix(vec, imu_model: int):
    """3x3 scale/misalignment matrix from its 6-vector (KALIBR fills the
    lower triangle column-wise, RPNG the upper, `State::Dm`)."""
    z = torch.zeros_like(vec[0])
    if imu_model == IMU_MODEL_KALIBR:
        rows = [[vec[0], z, z], [vec[1], vec[3], z], [vec[2], vec[4], vec[5]]]
    else:
        rows = [[vec[0], vec[1], vec[3]], [z, vec[2], vec[4]], [z, z, vec[5]]]
    return torch.stack([torch.stack(r) for r in rows])


def tg_matrix(vec):
    """3x3 gravity-sensitivity matrix, column-wise fill (`State::Tg`)."""
    return vec.reshape(3, 3).T


@dataclasses.dataclass(frozen=True)
class NoiseManager:
    """Continuous-time IMU noise sigmas (`ov_core` NoiseManager)."""

    sigma_w: float = 1.6968e-04  # gyro white noise (rad/s/sqrt(hz))
    sigma_wb: float = 1.9393e-05  # gyro bias walk
    sigma_a: float = 2.0000e-3  # accel white noise
    sigma_ab: float = 3.0000e-03  # accel bias walk


def _bmv(M, v):
    """Batched matrix-vector product (...,i,j) x (...,j) -> (...,i)."""
    return (M @ v[..., None])[..., 0]


def _unit_quat(like):
    """Identity quaternions [0,0,0,1] shaped like `like` (...,k)."""
    q = (torch.arange(4, device=like.device) == 3).to(like.dtype)
    return q.expand(like.shape[:-1] + (4,))


def _rk4_deltas(w1, a1, w2, a2, dt):
    """Input-only decomposition of one RK4 step, batched over intervals:
    (dq, Jv, Jp) with v' = v + R^T Jv - g dt and
    p' = p + v dt + R^T Jp - g dt^2/2 (`uvio_tpu` `_rk4_deltas`)."""
    dt = dt[..., None]
    w_mid = 0.5 * (w1 + w2)
    a_mid = 0.5 * (a1 + a2)
    dq0 = _unit_quat(w1)
    k1_q = 0.5 * _bmv(omega(w1), dq0)
    dq1 = quat_norm(dq0 + 0.5 * k1_q * dt)
    k2_q = 0.5 * _bmv(omega(w_mid), dq1)
    dq2 = quat_norm(dq0 + 0.5 * k2_q * dt)
    k3_q = 0.5 * _bmv(omega(w_mid), dq2)
    dq3 = quat_norm(dq0 + k3_q * dt)
    k4_q = 0.5 * _bmv(omega(w2), dq3)
    dq = quat_norm(dq0 + (dt / 6.0) * (k1_q + 2 * k2_q + 2 * k3_q + k4_q))

    R1t = quat_to_rot(dq1).transpose(-1, -2)
    R2t = quat_to_rot(dq2).transpose(-1, -2)
    R3t = quat_to_rot(dq3).transpose(-1, -2)
    Jv = (dt / 6.0) * (a1 + 2.0 * _bmv(R1t, a_mid) + 2.0 * _bmv(R2t, a_mid) + _bmv(R3t, a2))
    Jp = (dt * dt / 6.0) * (a1 + _bmv(R1t, a_mid) + _bmv(R2t, a_mid))
    return dq, Jv, Jp


def _xi_sum(w_hat, a_hat, dt):
    """Closed-form ACI² integration components (`compute_Xi_sum`,
    `Propagator.cpp:588-668`) batched over intervals: (Xi_1, Xi_2,
    Jr_ktok1, Xi_3, Xi_4), with the small-w series switch as a select.
    (`R_ktok1` feeds only the analytical mean, not the rk4 path.)"""
    eye3 = torch.eye(3, dtype=w_hat.dtype, device=w_hat.device)
    w_norm = torch.linalg.vector_norm(w_hat, dim=-1)
    safe_w = torch.clamp(w_norm, min=1e-15)
    k_hat = w_hat / safe_w[..., None]
    d_th = w_norm * dt
    d_t2, d_t3 = dt * dt, dt * dt * dt
    w2, w3 = safe_w * safe_w, safe_w * safe_w * safe_w
    cth, sth = torch.cos(d_th), torch.sin(d_th)
    d_th2, d_th3 = d_th * d_th, d_th * d_th * d_th
    sK = skew(k_hat)
    sK2 = sK @ sK
    sA = skew(a_hat)
    kdota = (k_hat * a_hat).sum(-1)

    def s(x):  # per-interval scalar -> (n,1,1)
        return x[..., None, None]

    Jr_ktok1 = jr_so3(-w_hat * dt[..., None])

    # constant-omega branch
    Xi1_l = s(dt) * eye3 + s((1.0 - cth) / safe_w) * sK + s(dt - sth / safe_w) * sK2
    Xi2_l = (
        s(0.5 * d_t2) * eye3 + s((d_th - sth) / w2) * sK
        + s(0.5 * d_t2 - (1.0 - cth) / w2) * sK2
    )
    Xi3_l = (
        s(0.5 * d_t2) * sA
        + s((sth - d_th) / w2) * sA @ sK
        + s((sth - d_th * cth) / w2) * sK @ sA
        + s(0.5 * d_t2 - (1.0 - cth) / w2) * sA @ sK2
        + s(0.5 * d_t2 + (1.0 - cth - d_th * sth) / w2) * (sK2 @ sA + s(kdota) * sK)
        - s((3.0 * sth - 2.0 * d_th - d_th * cth) / w2 * kdota) * sK2
    )
    Xi4_l = (
        s(d_t3 / 6.0) * sA
        + s((2.0 * (1.0 - cth) - d_th2) / (2.0 * w3)) * sA @ sK
        + s((2.0 * (1.0 - cth) - d_th * sth) / w3) * sK @ sA
        + s((sth - d_th) / w3 + d_t3 / 6.0) * sA @ sK2
        + s((d_th - 2.0 * sth + d_th3 / 6.0 + d_th * cth) / w3) * (sK2 @ sA + s(kdota) * sK)
        + s((4.0 * cth - 4.0 + d_th2 + d_th * sth) / w3 * kdota) * sK2
    )
    # small-w series branch
    Xi1_s = s(dt) * (eye3 + s(sth) * sK + s(1.0 - cth) * sK2)
    Xi2_s = s(0.5 * dt) * Xi1_s
    Xi3_s = s(0.5 * d_t2) * (
        sA
        + s(sth) * (-sA @ sK + sK @ sA + s(kdota) * sK2)
        + s(1.0 - cth) * (sA @ sK2 + sK2 @ sA + s(kdota) * sK)
    )
    Xi4_s = s(dt / 3.0) * Xi3_s

    small = s(w_norm < math.pi / 360.0)  # 0.5 deg total
    pick = lambda a, b: torch.where(small, a, b)
    return pick(Xi1_s, Xi1_l), pick(Xi2_s, Xi2_l), Jr_ktok1, pick(Xi3_s, Xi3_l), pick(Xi4_s, Xi4_l)


def _f_and_g_analytic(R_k, p_k, v_k, new_q, new_p, new_v, dt, gravity, xi, RwDw, RaDa, TgM):
    """F (n,15,15) and G (n,15,12) with the ACI² closed-form noise/bias
    integrals (`compute_F_and_G_analytic`, `Propagator.cpp:693-829`),
    for a layout without IMU-intrinsic error states."""
    n = R_k.shape[0]
    dtype, device = R_k.dtype, R_k.device
    eye3 = torch.eye(3, dtype=dtype, device=device)
    Xi1, Xi2, Jr_ktok1, Xi3, Xi4 = xi
    dt3 = dt[:, None, None]
    RkT = R_k.transpose(-1, -2)
    dR = quat_to_rot(new_q) @ RkT
    dRJrdt = dR @ Jr_ktok1 * dt3
    P4 = RkT @ Xi4
    P3 = RkT @ Xi3
    P2w = RkT @ (Xi2 + Xi4 @ RwDw @ TgM)
    P1w = RkT @ (Xi1 + Xi3 @ RwDw @ TgM)
    dp = new_p - p_k - v_k * dt[:, None] + 0.5 * gravity * (dt * dt)[:, None]
    dv = new_v - v_k + gravity * dt[:, None]

    F = torch.zeros((n, 15, 15), dtype=dtype, device=device)
    F[:, 0:3, 0:3] = dR
    F[:, 3:6, 0:3] = -skew(dp) @ RkT
    F[:, 6:9, 0:3] = -skew(dv) @ RkT
    F[:, 3:6, 3:6] = eye3
    F[:, 3:6, 6:9] = eye3 * dt3
    F[:, 6:9, 6:9] = eye3
    F[:, 0:3, 9:12] = -dRJrdt @ RwDw
    F[:, 3:6, 9:12] = P4 @ RwDw
    F[:, 6:9, 9:12] = P3 @ RwDw
    F[:, 9:12, 9:12] = eye3
    F[:, 0:3, 12:15] = dRJrdt @ RwDw @ TgM @ RaDa
    F[:, 3:6, 12:15] = -P2w @ RaDa
    F[:, 6:9, 12:15] = -P1w @ RaDa
    F[:, 12:15, 12:15] = eye3

    G = torch.zeros((n, 15, 12), dtype=dtype, device=device)
    G[:, 0:3, 0:3] = -dRJrdt @ RwDw
    G[:, 3:6, 0:3] = P4 @ RwDw
    G[:, 6:9, 0:3] = P3 @ RwDw
    G[:, 0:3, 3:6] = dRJrdt @ RwDw @ TgM @ RaDa
    G[:, 3:6, 3:6] = -P2w @ RaDa
    G[:, 6:9, 3:6] = -P1w @ RaDa
    G[:, 9:12, 6:9] = eye3 * dt3
    G[:, 12:15, 9:12] = eye3 * dt3
    return F, G


def _quat_prefix_products(dq):
    """Inclusive prefix products S_k = dq_k ⊗ ... ⊗ dq_0 by log-depth
    doubling (Hillis–Steele) over the static window length; stands in
    for `lax.associative_scan`."""
    n = dq.shape[0]
    S = dq
    k = 1
    while k < n:
        S = torch.cat([S[:k], quat_multiply(S[k:], S[:-k])], dim=0)
        k *= 2
    return S


def _shift_in(first, rest):
    """[first, rest[:-1]]: interval start values from their end values."""
    return torch.cat([first[None], rest[:-1]], dim=0)


def propagate_mean_cov(
    state: FilterState,
    layout: StateLayout,
    imu_t: torch.Tensor,
    imu_w: torch.Tensor,
    imu_a: torch.Tensor,
    noises: NoiseManager,
    gravity_mag: float,
    integration: str = INTEGRATION_RK4,
    stamp_time: torch.Tensor = None,
):
    """Propagate mean+covariance through a padded IMU window.

    imu_t (M,) f64, imu_w (M,3), imu_a (M,3) on the state's device;
    intervals are consecutive sample pairs, padding repeats the last
    timestamp (dt == 0 -> identity). Returns (new_state, w_hat_last),
    the bias-corrected angular rate at the end (for the clone's
    time-offset Jacobian). `stamp_time` is stored as the state time
    (camera clock); it defaults to imu_t[-1].
    """
    if integration != INTEGRATION_RK4:
        raise ValueError(f"integration {integration!r} is not ported; only 'rk4' is")
    if layout.imu_intr_dim:
        raise NotImplementedError("IMU-intrinsic error states are not ported")
    dtype, device = state.cov.dtype, state.cov.device
    # (built without element assignment: writing a Python scalar into a
    # CUDA tensor element copies it from the host)
    gravity = gravity_mag * (torch.arange(3, device=device) == 2).to(dtype)
    imu_w = imu_w.to(dtype)
    imu_a = imu_a.to(dtype)

    # IMU intrinsic correction matrices (identity unless seeded):
    #   a_I = R_AtoI Da (a_m - ba);  w_I = R_WtoI Dw (w_m - bg - Tg a_I)
    model = layout.imu_model
    TgM = tg_matrix(state.calib_imu_tg)
    RwDw = quat_to_rot(state.calib_imu_gq) @ dm_matrix(state.calib_imu_dw, model)
    RaDa = quat_to_rot(state.calib_imu_aq) @ dm_matrix(state.calib_imu_da, model)

    # -- pass 0: batched measurement correction ------------------------
    dts = (imu_t[1:] - imu_t[:-1]).to(dtype)  # (n,)
    has = dts > 0
    safe_dt = torch.where(has, dts, torch.ones_like(dts))
    a_c = (imu_a - state.ba) @ RaDa.T
    w_c = (imu_w - state.bg - a_c @ TgM.T) @ RwDw.T
    w1, w2 = w_c[:-1], w_c[1:]
    a1, a2 = a_c[:-1], a_c[1:]
    w_hat = 0.5 * (w1 + w2)
    a_hat = 0.5 * (a1 + a2)
    xi = _xi_sum(w_hat, a_hat, safe_dt)

    # -- pass 1: mean via per-interval deltas + prefix composition -----
    #     q_{k+1} = dq_k (x) q_k
    #     v_{k+1} = v_k + R(q_k)^T Jv_k - g dt_k
    #     p_{k+1} = p_k + v_k dt_k + R(q_k)^T Jp_k - g dt_k^2 / 2
    dq, Jv, Jp = _rk4_deltas(w1, a1, w2, a2, dts)
    hmask = has[:, None]
    dq = torch.where(hmask, dq, _unit_quat(dq))
    Jv = torch.where(hmask, Jv, torch.zeros_like(Jv))
    Jp = torch.where(hmask, Jp, torch.zeros_like(Jp))
    dts_m = torch.where(has, dts, torch.zeros_like(dts))

    q0, p0, v0 = state.q, state.p, state.v
    q_e = quat_multiply(_quat_prefix_products(dq), q0[None])  # (n,4) interval ends
    q_s = _shift_in(q0, q_e)
    R_s = quat_to_rot(q_s)  # (n,3,3) R_GtoI at interval starts
    RsT = R_s.transpose(-1, -2)
    dv = _bmv(RsT, Jv) - gravity[None] * dts_m[:, None]
    v_e = v0[None] + torch.cumsum(dv, dim=0)
    v_s = _shift_in(v0, v_e)
    dp = v_s * dts_m[:, None] + _bmv(RsT, Jp) - 0.5 * gravity[None] * (dts_m**2)[:, None]
    p_e = p0[None] + torch.cumsum(dp, dim=0)
    p_s = _shift_in(p0, p_e)
    q, p, v = q_e[-1], p_e[-1], v_e[-1]

    # FEJ: interval 0 linearizes at the stored first estimate; every later
    # interval starts at its value == fej (`Propagator.cpp:473-479`)
    R_s = torch.cat([quat_to_rot(state.q_fej)[None], R_s[1:]], dim=0)
    p_s = torch.cat([state.p_fej[None], p_s[1:]], dim=0)
    v_s = torch.cat([state.v_fej[None], v_s[1:]], dim=0)

    # -- pass 2: batched F/G construction -------------------------------
    F, G = _f_and_g_analytic(R_s, p_s, v_s, q_e, p_e, v_e, safe_dt, gravity, xi, RwDw, RaDa, TgM)
    eye15 = torch.eye(15, dtype=dtype, device=device)
    F = torch.where(has[:, None, None], F, eye15)
    G = torch.where(has[:, None, None], G, torch.zeros_like(G))

    # per-interval discrete noise: Qd_i = G diag(qc) G^T
    sig = torch.cat([
        torch.full((3,), noises.sigma_w**2, dtype=dtype, device=device),
        torch.full((3,), noises.sigma_a**2, dtype=dtype, device=device),
        torch.full((3,), noises.sigma_wb**2, dtype=dtype, device=device),
        torch.full((3,), noises.sigma_ab**2, dtype=dtype, device=device),
    ])
    qc = sig[None, :] / safe_dt[:, None]  # (n,12)
    Qd = (G * qc[:, None, :]) @ G.transpose(-1, -2)
    Qd = 0.5 * (Qd + Qd.transpose(-1, -2))

    # -- pass 3: log-depth composition of (Phi, Qd) ---------------------
    # composing segment A (first) with B: Phi = B A ; Q = B Q_A B^T + Q_B
    Phi = F
    n = Phi.shape[0]
    pow2 = 1 << max(n - 1, 0).bit_length()
    if pow2 > n:
        pad = pow2 - n
        Phi = torch.cat([Phi, eye15.expand(pad, 15, 15)], dim=0)
        Qd = torch.cat([Qd, torch.zeros((pad, 15, 15), dtype=dtype, device=device)], dim=0)
    while Phi.shape[0] > 1:
        A, B = Phi[0::2], Phi[1::2]
        Qd = B @ Qd[0::2] @ B.transpose(-1, -2) + Qd[1::2]
        Phi = B @ A
    Qd = 0.5 * (Qd[0] + Qd[0].T)

    cov = propagate_covariance(state.cov, Phi[0], Qd)
    new_state = state.replace(
        q=q, p=p, v=v, q_fej=q, p_fej=p, v_fej=v, cov=cov,
        time=imu_t[-1] if stamp_time is None else stamp_time,
    )
    return new_state, w_c[-1]


def propagate_and_clone(
    state: FilterState,
    layout: StateLayout,
    imu_t: torch.Tensor,
    imu_w: torch.Tensor,
    imu_a: torch.Tensor,
    noises: NoiseManager,
    gravity_mag: float,
    integration: str = INTEGRATION_RK4,
    stamp_time: torch.Tensor = None,
) -> FilterState:
    """`Propagator::propagate_and_clone`: propagate to the newest image
    time, then stochastically clone."""
    new_state, w_hat = propagate_mean_cov(
        state, layout, imu_t, imu_w, imu_a, noises, gravity_mag,
        integration=integration, stamp_time=stamp_time,
    )
    return augment_clone(new_state, layout, w_hat)


def select_imu_readings_np(
    times: np.ndarray, ws: np.ndarray, accs: np.ndarray, t0: float, t1: float, m_max: int
):
    """Host-side IMU slicing with boundary interpolation
    (`Propagator::select_imu_readings` + `interpolate_data`): the samples
    covering [t0, t1] with interpolated boundary samples, padded by
    repeating the last one to `m_max` rows.
    Returns (t (m_max,), w (m_max,3), a (m_max,3))."""
    if not t1 > t0:
        raise ValueError("backwards propagation request")

    def interp(t):
        i = np.searchsorted(times, t)
        i = np.clip(i, 1, len(times) - 1)
        lam = (t - times[i - 1]) / (times[i] - times[i - 1])
        return (1 - lam) * ws[i - 1] + lam * ws[i], (1 - lam) * accs[i - 1] + lam * accs[i]

    sel = (times > t0) & (times < t1)
    w0, a0 = interp(t0)
    w1, a1 = interp(t1)
    t = np.concatenate([[t0], times[sel], [t1]])
    w = np.concatenate([[w0], ws[sel], [w1]])
    a = np.concatenate([[a0], accs[sel], [a1]])
    if len(t) > m_max:
        raise ValueError(
            f"IMU batch {len(t)} exceeds max_imu_batch={m_max}; raise the layout limit"
        )
    pad = m_max - len(t)
    t = np.concatenate([t, np.full(pad, t[-1])])
    w = np.concatenate([w, np.tile(w[-1], (pad, 1))])
    a = np.concatenate([a, np.tile(a[-1], (pad, 1))])
    return t, w, a

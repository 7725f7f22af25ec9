"""A plain UWB-aided MSCKF (OpenVINS with UVIO's range update), in NumPy
float64, written for the benchmark's check from the published method and
imports nothing of the estimator it judges.

It runs a configuration that `config.EstimatorConfig.supported()` accepts:
one radial-tangential camera, GLOBAL_3D MSCKF features, RK4 propagation
with OpenVINS's closed-form (ACI2) state transition and first-estimate
Jacobians, no SLAM landmarks, no online camera or IMU calibration, and
UWB anchors with their biases and the tag's lever arm estimated. The
state starts from the truth (`initialize_with_gt`).

The error state is kept the plain way, grown and shrunk as OpenVINS's
`StateHelper` does: `[imu (15) | lever arm (3) | anchors (5 each) |
clones (6 each, oldest first)]`, the IMU as theta p v bg ba. Each frame:

  1. every buffered range set older than the frame: propagate to its
     time (no clone), then one chi2-gated update per range in anchor
     order; the IMU's first estimates then move to the updated mean;
  2. propagate to the frame's time and clone the pose;
  3. the MSCKF update with the features that left the view and those
     seen at the clone about to go, longest tracks first, at most
     `max_msckf_in_update`: triangulate (linear, then five Gauss-Newton
     steps in inverse depth), project out the feature, gate each at 95%
     chi2, and update once with all that pass;
  4. marginalize the oldest clone when the window is full.

Range sets are taken once the vehicle has travelled `min_dist_to_use_uwb`
(summed over frames), as UVIO gates them.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
from scipy import stats

from .config import EstimatorConfig
from .geometry import EYE3, distort, distort_jacobian, error_quat, jl_so3, omega, quat_mul, quat_to_rot, skew, undistort

GN_ITERS = 5  # Gauss-Newton steps of a feature's triangulation
MIN_DEPTH, MAX_DEPTH, MAX_COND = 0.1, 60.0, 10000.0  # triangulation's gates
MAX_BASELINE = 40.0  # a feature's distance over its largest baseline
SMALL_RATE = np.pi / 360.0  # rad/s: below it the ACI2 integrals use their series
UWB_SETS_PER_FRAME = 4  # range sets a frame can take before the estimator drains them apart


class CovarianceError(RuntimeError):
    pass


@dataclasses.dataclass
class Clone:
    t: float
    q: np.ndarray
    p: np.ndarray
    q_fej: np.ndarray
    p_fej: np.ndarray
    slot: int  # its place in the estimator's ring of clone slots


@functools.lru_cache(maxsize=None)
def chi2_95(dof: int) -> float:
    return float(stats.chi2.ppf(0.95, dof))


def rk4(q0, p0, v0, w1, a1, w2, a2, dt, g):
    """OpenVINS's `predict_mean_rk4`: the JPL kinematics from (w1, a1) to
    (w2, a2), both linear over `dt`."""
    dq0 = np.array([0.0, 0.0, 0.0, 1.0])
    w_mid, a_mid = w1 + 0.5 * (w2 - w1), a1 + 0.5 * (a2 - a1)

    def f(dq, w, a):
        R = quat_to_rot(quat_mul(dq, q0))
        return 0.5 * omega(w) @ dq, R.T @ a - g

    def unit(q):
        return q / np.sqrt(q @ q) * (1.0 if q[3] >= 0 else -1.0)

    k1q, k1v = f(dq0, w1, a1)
    k1p = v0
    dq1 = unit(dq0 + 0.5 * dt * k1q)
    k2q, k2v = f(dq1, w_mid, a_mid)
    k2p = v0 + 0.5 * dt * k1v
    dq2 = unit(dq0 + 0.5 * dt * k2q)
    k3q, k3v = f(dq2, w_mid, a_mid)
    k3p = v0 + 0.5 * dt * k2v
    dq3 = unit(dq0 + dt * k3q)
    k4q, k4v = f(dq3, w2, a2)
    k4p = v0 + dt * k3v
    dq = unit(dq0 + dt / 6.0 * (k1q + 2.0 * k2q + 2.0 * k3q + k4q))
    return (quat_mul(dq, q0), p0 + dt / 6.0 * (k1p + 2.0 * k2p + 2.0 * k3p + k4p),
            v0 + dt / 6.0 * (k1v + 2.0 * k2v + 2.0 * k3v + k4v))


def xi_sums(w, a, dt):
    """OpenVINS's `compute_Xi_sum` for constant (w, a) over dt, for each
    of n intervals: (Xi1, Xi2, Xi3, Xi4, Jr(w dt)), each (n, 3, 3). Below
    `SMALL_RATE` the series of the integrals stands in for them."""
    Jr = jl_so3(w * dt[:, None])
    wn = np.sqrt(np.sum(w * w, axis=1))
    small = wn < SMALL_RATE
    k = w / np.maximum(wn, 1e-15)[:, None]
    th = wn * dt
    sK, sA = skew(k), skew(a)
    sK2 = sK @ sK
    ka = np.sum(k * a, axis=1)[:, None, None]
    c, s = np.cos(th)[:, None, None], np.sin(th)[:, None, None]
    th, dt = th[:, None, None], dt[:, None, None]
    dt2, dt3 = dt * dt, dt * dt * dt
    w1 = np.where(small, 1.0, wn)[:, None, None]
    w2, w3 = w1 * w1, w1 * w1 * w1
    xi1 = dt * EYE3 + (1.0 - c) / w1 * sK + (dt - s / w1) * sK2
    xi2 = 0.5 * dt2 * EYE3 + (th - s) / w2 * sK + (0.5 * dt2 - (1.0 - c) / w2) * sK2
    xi3 = (0.5 * dt2 * sA + (s - th) / w2 * sA @ sK + (s - th * c) / w2 * sK @ sA
           + (0.5 * dt2 - (1.0 - c) / w2) * sA @ sK2
           + (0.5 * dt2 + (1.0 - c - th * s) / w2) * (sK2 @ sA + ka * sK)
           - (3.0 * s - 2.0 * th - th * c) / w2 * ka * sK2)
    xi4 = (dt3 / 6.0 * sA + (2.0 * (1.0 - c) - th * th) / (2.0 * w3) * sA @ sK
           + (2.0 * (1.0 - c) - th * s) / w3 * sK @ sA + ((s - th) / w3 + dt3 / 6.0) * sA @ sK2
           + (th - 2.0 * s + th ** 3 / 6.0 + th * c) / w3 * (sK2 @ sA + ka * sK)
           + (4.0 * c - 4.0 + th * th + th * s) / w3 * ka * sK2)
    # the series, for slow rotation
    sx1 = dt * (EYE3 + s * sK + (1.0 - c) * sK2)
    sx3 = 0.5 * dt2 * (sA + s * (-sA @ sK + sK @ sA + ka * sK2) + (1.0 - c) * (sA @ sK2 + sK2 @ sA + ka * sK))
    m = small[:, None, None]
    return (np.where(m, sx1, xi1), np.where(m, 0.5 * dt * sx1, xi2), np.where(m, sx3, xi3),
            np.where(m, dt / 3.0 * sx3, xi4), Jr)


class Feature:
    __slots__ = ("fid", "obs")

    def __init__(self, fid: int):
        self.fid = fid
        self.obs: List[tuple] = []  # (t, u, v), oldest first


class UVio:
    """The estimator. Feed it as the program is fed: `feed_imu`,
    `feed_uwb`, `feed_features`, after `initialize_with_gt`."""

    def __init__(self, cfg: EstimatorConfig):
        missing = cfg.supported()
        if missing:
            raise NotImplementedError(f"the plain reference does not implement: {', '.join(missing)}")
        self.cfg = cfg
        cam = cfg.cameras[0]
        self.intr, self.R_ItoC, self.p_IinC = cam.intrinsics, cam.R_ItoC, cam.p_IinC
        self.g = np.array([0.0, 0.0, cfg.gravity_mag])
        self.noise = np.array([cfg.sigma_w ** 2] * 3 + [cfg.sigma_a ** 2] * 3 + [cfg.sigma_wb ** 2] * 3
                              + [cfg.sigma_ab ** 2] * 3)
        self.ring = cfg.max_clones + 1
        self.lever = cfg.p_IinU.copy()
        self.lever_off = 15 if cfg.calib_uwb_extrinsics else None
        n_lever = 3 if cfg.calib_uwb_extrinsics else 0
        self.anchor_off = 15 + n_lever
        self.anchors_p = np.array([a.p_AinG for a in cfg.anchors]).reshape(-1, 3)
        self.gamma = np.array([a.gamma for a in cfg.anchors])
        self.alpha = np.array([a.alpha for a in cfg.anchors])
        self.slot_of = {a.anchor_id: i for i, a in enumerate(cfg.anchors)}
        self.clone_off = self.anchor_off + 5 * len(cfg.anchors)
        self.cov = np.zeros((self.clone_off, self.clone_off))
        if n_lever:
            self.cov[15:18, 15:18] = cfg.p_IinU_prior_var * EYE3
        for i, a in enumerate(cfg.anchors):
            o = self.anchor_off + 5 * i
            self.cov[o:o + 5, o:o + 5] = np.diag(a.prior_var)
        self.clones: List[Clone] = []
        self.head = -1
        self.features: Dict[int, Feature] = {}
        self.imu_t: List[float] = []
        self.imu_w: List[np.ndarray] = []
        self.imu_a: List[np.ndarray] = []
        self.uwb_buffer: List[tuple] = []
        self.last_uwb_t = -np.inf
        self.initialized = False
        self.distance = 0.0
        self.last_p: Optional[np.ndarray] = None

    # --- the state ------------------------------------------------------

    def initialize_with_gt(self, t, q, p, v, bg, ba):
        """The truth at `t`, with OpenVINS's ground-truth prior (std 0.017
        rad, 0.05 m, 0.01 m/s, 0.02 for both biases)."""
        self.time = float(t)
        self.q, self.p, self.v = (np.asarray(x, float).copy() for x in (q, p, v))
        self.bg, self.ba = np.asarray(bg, float).copy(), np.asarray(ba, float).copy()
        self.q_fej, self.p_fej, self.v_fej = self.q.copy(), self.p.copy(), self.v.copy()
        self.cov[:15, :] = 0.0
        self.cov[:, :15] = 0.0
        self.cov[:15, :15] = np.diag(np.repeat([0.017, 0.05, 0.01, 0.02, 0.02], 3) ** 2)
        self.initialized = True

    def _offset(self, j: int) -> int:
        return self.clone_off + 6 * j

    def _inject(self, dx):
        self.q = quat_mul(error_quat(dx[0:3]), self.q)
        self.p = self.p + dx[3:6]
        self.v = self.v + dx[6:9]
        self.bg = self.bg + dx[9:12]
        self.ba = self.ba + dx[12:15]
        if self.lever_off is not None:
            self.lever = self.lever + dx[self.lever_off:self.lever_off + 3]
        for i in range(len(self.anchors_p)):
            d = dx[self.anchor_off + 5 * i:self.anchor_off + 5 * i + 5]
            self.anchors_p[i] = self.anchors_p[i] + d[:3]
            self.gamma[i] += d[3]
            self.alpha[i] += d[4]
        for j, c in enumerate(self.clones):
            d = dx[self._offset(j):self._offset(j) + 6]
            c.q = quat_mul(error_quat(d[:3]), c.q)
            c.p = c.p + d[3:]

    def _ekf_update(self, H, r, var):
        """K = P H^T (H P H^T + var I)^-1; P <- P - K H P; x <- x (+) K r.
        Returns whether the covariance's diagonal stayed non-negative."""
        PHt = self.cov @ H.T
        S = H @ PHt + var * np.eye(len(r))
        K = np.linalg.solve(0.5 * (S + S.T), PHt.T).T
        P = self.cov - K @ PHt.T
        self.cov = 0.5 * (P + P.T)
        self._inject(K @ r)
        return bool(np.all(np.diag(self.cov) > -1e-9))

    # --- propagation -----------------------------------------------------

    def _imu_window(self, t0: float, t1: float):
        """The samples between t0 and t1, both ends interpolated linearly
        between the samples around them."""
        T = self.imu_t

        def at(t):
            i = min(max(bisect.bisect_left(T, t), 1), len(T) - 1)
            lam = (t - T[i - 1]) / (T[i] - T[i - 1])
            return (1.0 - lam) * self.imu_w[i - 1] + lam * self.imu_w[i], (1.0 - lam) * self.imu_a[i - 1] + lam * self.imu_a[i]

        lo, hi = bisect.bisect_right(T, t0), bisect.bisect_left(T, t1)
        w0, a0 = at(t0)
        w1, a1 = at(t1)
        return ([t0] + T[lo:hi] + [t1], [w0] + self.imu_w[lo:hi] + [w1], [a0] + self.imu_a[lo:hi] + [a1])

    def _transitions(self, R_k, p_k, v_k, R_1, p_1, v_1, w, a, dt):
        """OpenVINS's `compute_F_and_G_analytic` for each of n intervals,
        from its linearization start (R_k, p_k, v_k) to its end (R_1, p_1,
        v_1): F (n, 15, 15) and G (n, 15, 12)."""
        n = len(dt)
        xi1, xi2, xi3, xi4, Jr = xi_sums(w, a, dt)
        RkT = np.swapaxes(R_k, 1, 2)
        dR = R_1 @ RkT
        dRJ = dR @ Jr * dt[:, None, None]
        g = self.g
        F = np.zeros((n, 15, 15))
        F[:] = np.eye(15)
        F[:, 0:3, 0:3] = dR
        F[:, 3:6, 0:3] = -skew(p_1 - p_k - v_k * dt[:, None] + 0.5 * g * (dt * dt)[:, None]) @ RkT
        F[:, 6:9, 0:3] = -skew(v_1 - v_k + g * dt[:, None]) @ RkT
        F[:, 3:6, 6:9] = dt[:, None, None] * EYE3
        F[:, 0:3, 9:12] = -dRJ
        F[:, 3:6, 9:12] = RkT @ xi4
        F[:, 6:9, 9:12] = RkT @ xi3
        F[:, 3:6, 12:15] = -RkT @ xi2
        F[:, 6:9, 12:15] = -RkT @ xi1
        G = np.zeros((n, 15, 12))
        G[:, 0:3, 0:3] = -dRJ
        G[:, 3:6, 0:3] = RkT @ xi4
        G[:, 6:9, 0:3] = RkT @ xi3
        G[:, 3:6, 3:6] = -RkT @ xi2
        G[:, 6:9, 3:6] = -RkT @ xi1
        G[:, 9:12, 6:9] = dt[:, None, None] * EYE3
        G[:, 12:15, 9:12] = dt[:, None, None] * EYE3
        return F, G

    def _propagate(self, t1: float):
        """Mean and covariance from the state's time to t1: the mean one
        interval after the other by RK4, each interval's transition at its
        start (the first at the first estimates), then Phi and Qd summed
        over the intervals."""
        tt, ww, aa = self._imu_window(self.time, max(t1, self.time + 1e-9))
        tt = np.asarray(tt)
        dt_all = np.diff(tt)
        use = np.flatnonzero(dt_all > 0.0)
        w = np.asarray(ww) - self.bg
        a = np.asarray(aa) - self.ba
        qs, ps, vs = [self.q], [self.p], [self.v]
        for k in use:
            q1, p1, v1 = rk4(qs[-1], ps[-1], vs[-1], w[k], a[k], w[k + 1], a[k + 1], dt_all[k], self.g)
            qs.append(q1)
            ps.append(p1)
            vs.append(v1)
        Rs = quat_to_rot(np.array(qs))
        R_k, p_k, v_k = Rs[:-1].copy(), np.array(ps[:-1]), np.array(vs[:-1])
        if len(use) and use[0] == 0:  # the first interval starts at the first estimates
            R_k[0], p_k[0], v_k[0] = quat_to_rot(self.q_fej), self.p_fej, self.v_fej
        dt = dt_all[use]
        F, G = self._transitions(R_k, p_k, v_k, Rs[1:], np.array(ps[1:]), np.array(vs[1:]),
                                 0.5 * (w[use] + w[use + 1]), 0.5 * (a[use] + a[use + 1]), dt)
        Q = (G * (self.noise[None, :] / dt[:, None])[:, None, :]) @ np.swapaxes(G, 1, 2)
        Phi, Qd = np.eye(15), np.zeros((15, 15))
        for i in range(len(dt)):
            Phi = F[i] @ Phi
            Qd = F[i] @ Qd @ F[i].T + Q[i]
        rows = Phi @ self.cov[:15, :]
        self.cov[:15, :] = rows
        self.cov[:, :15] = rows.T
        block = rows[:, :15] @ Phi.T + Qd
        self.cov[:15, :15] = 0.5 * (block + block.T)
        self.q, self.p, self.v = qs[-1], ps[-1], vs[-1]
        self.q_fej, self.p_fej, self.v_fej = self.q.copy(), self.p.copy(), self.v.copy()
        self.time = float(t1)

    def _clone(self):
        D = len(self.cov)
        cov = np.zeros((D + 6, D + 6))
        cov[:D, :D] = self.cov
        cov[D:, :D] = self.cov[:6, :]
        cov[:D, D:] = self.cov[:, :6]
        cov[D:, D:] = self.cov[:6, :6]
        self.cov = cov
        self.head = 0 if self.head < 0 else (self.head + 1) % self.ring
        self.clones.append(Clone(self.time, self.q.copy(), self.p.copy(), self.q.copy(), self.p.copy(), self.head))

    def _marginalize_oldest(self):
        o = self._offset(0)
        keep = np.r_[0:o, o + 6:len(self.cov)]
        self.cov = self.cov[np.ix_(keep, keep)]
        return self.clones.pop(0).t

    # --- UWB -------------------------------------------------------------

    def _range(self, i: int):
        """(predicted range, its Jacobian over the error state) of anchor
        i. Range model: y = (1 + alpha) |p_A - p_U| + gamma, with the tag
        at p_U = p_I - R_GtoI^T p_IinU."""
        R = quat_to_rot(self.q)
        diff = self.anchors_p[i] - (self.p - R.T @ self.lever)
        d = np.sqrt(diff @ diff)
        u = diff / d
        k = 1.0 + self.alpha[i]
        H = np.zeros(len(self.cov))
        H[0:3] = -k * (u @ R.T @ skew(self.lever))
        H[3:6] = -k * u
        if self.lever_off is not None:
            H[self.lever_off:self.lever_off + 3] = k * (u @ R.T)
        o = self.anchor_off + 5 * i
        H[o:o + 3] = k * u
        H[o + 3] = 1.0
        H[o + 4] = d
        return k * d + self.gamma[i], H

    def _uwb_update(self, ranges: Dict[int, float]):
        """One update per range, anchor by anchor, each gated at 95% chi2
        of one dof."""
        var = self.cfg.sigma_range ** 2
        for i in sorted(ranges):
            y_hat, H = self._range(i)
            r = ranges[i] - y_hat
            if r * r / (H @ self.cov @ H + var) < self.cfg.uwb_chi2_mult * chi2_95(1):
                self._ekf_update(H[None, :], np.array([r]), var)

    # --- MSCKF -------------------------------------------------------------

    def _triangulate(self, uvn, R_GtoC, p_CinG):
        """Features observed n times each, (B, n, ...): linear
        triangulation in the global frame, gated by its condition number
        and the depth in every observing camera; then Gauss-Newton in
        inverse depth (alpha, beta, rho) in the frame of each feature's
        first observation. Returns (p_FinG (B, 3), ok (B,))."""
        b = np.concatenate([uvn, np.ones(uvn.shape[:2] + (1,))], axis=2)
        bG = np.einsum("bmji,bmj->bmi", R_GtoC, b)
        bG /= np.linalg.norm(bG, axis=2, keepdims=True)
        NtN = EYE3 - bG[..., :, None] * bG[..., None, :]  # [b]x^T [b]x of a unit bearing
        A = NtN.sum(axis=1)
        p_f = np.linalg.solve(A, np.einsum("bmij,bmj->bi", NtN, p_CinG)[..., None])[..., 0]
        ev = np.linalg.eigvalsh(A)
        z = np.einsum("bmij,bmj->bmi", R_GtoC, p_f[:, None, :] - p_CinG)[..., 2]
        ok = ((ev[:, -1] / np.maximum(ev[:, 0], 1e-18) < MAX_COND) & np.all((z > MIN_DEPTH) & (z < MAX_DEPTH), axis=1)
              & np.all(np.isfinite(p_f), axis=1))
        R_A, p_A = R_GtoC[:, 0], p_CinG[:, 0]
        R_AtoC = R_GtoC @ np.swapaxes(R_A, 1, 2)[:, None]
        p_AinC = np.einsum("bmij,bmj->bmi", R_GtoC, p_A[:, None, :] - p_CinG)
        f = np.einsum("bij,bj->bi", R_A, p_f - p_A)
        x = np.stack([f[:, 0] / f[:, 2], f[:, 1] / f[:, 2], 1.0 / f[:, 2]], axis=1)
        dh = np.stack([R_AtoC[..., 0], R_AtoC[..., 1], p_AinC], axis=3)  # d h / d (alpha, beta, rho)
        for _ in range(GN_ITERS):
            bearing = np.concatenate([x[:, :2], np.ones((len(x), 1))], axis=1)
            h = np.einsum("bmij,bj->bmi", R_AtoC, bearing) + x[:, None, 2:3] * p_AinC
            hz = h[..., 2:3]
            r = (h[..., :2] / hz - uvn).reshape(len(x), -1)
            J = ((dh[..., :2, :] * hz[..., None] - h[..., :2, None] * dh[..., 2:3, :]) / (hz * hz)[..., None])
            J = J.reshape(len(x), -1, 3)
            JtJ = np.swapaxes(J, 1, 2) @ J + 1e-9 * EYE3
            x = x - np.linalg.solve(JtJ, (np.swapaxes(J, 1, 2) @ r[..., None]))[..., 0]
        rho = x[:, 2]
        ok &= rho > 1e-4
        f = np.concatenate([x[:, :2], np.ones((len(x), 1))], axis=1) / np.where(rho > 1e-4, rho, 1.0)[:, None]
        dist = np.linalg.norm(f, axis=1)
        dirn = f / np.maximum(dist, 1e-9)[:, None]
        p_CinA = np.einsum("bij,bmj->bmi", R_A, p_CinG - p_A[:, None, :])
        orth = p_CinA - np.einsum("bm,bi->bmi", np.einsum("bmi,bi->bm", p_CinA, dirn), dirn)
        ok &= (dist < MAX_BASELINE * np.maximum(np.linalg.norm(orth, axis=2).max(axis=1), 1e-12)) & np.all(
            np.isfinite(f), axis=1)
        return np.einsum("bji,bj->bi", R_A, f) + p_A, ok

    def _feature_systems(self, J, uv):
        """Features observed n times each at the clones `J` (B, n), oldest
        ring slot first, at pixels `uv` (B, n, 2): for those that
        triangulate, (H_x (B', 2n-3, D), r (B', 2n-3)) with the feature
        projected out."""
        B, n = J.shape
        R_GtoI, R_fej = self._R[J], self._R_fej[J]
        P_I, P_fej = self._P[J], self._P_fej[J]
        R_GtoC = self.R_ItoC @ R_GtoI
        p_CinG = P_I - np.einsum("bmji,j->bmi", R_GtoC, self.p_IinC)
        p_f, ok = self._triangulate(undistort(self.intr, uv.reshape(-1, 2)).reshape(B, n, 2), R_GtoC, p_CinG)
        J, uv, R_GtoI, R_fej, P_I, P_fej, p_f = (x[ok] for x in (J, uv, R_GtoI, R_fej, P_I, P_fej, p_f))
        B = len(J)
        if not B:
            return None
        p_FinC = np.einsum("ij,bmj->bmi", self.R_ItoC, np.einsum("bmij,bmj->bmi", R_GtoI, p_f[:, None] - P_I))
        p_FinC = p_FinC + self.p_IinC
        xy = (p_FinC[..., :2] / p_FinC[..., 2:3]).reshape(-1, 2)
        r = (uv.reshape(-1, 2) - distort(self.intr, xy)).reshape(B, 2 * n)
        # Jacobians at the first estimates, the distortion's at the current point
        p_FinI_fej = np.einsum("bmij,bmj->bmi", R_fej, p_f[:, None] - P_fej)
        p_FinC_fej = p_FinI_fej @ self.R_ItoC.T + self.p_IinC
        z = p_FinC_fej[..., 2]
        dproj = np.zeros((B, n, 2, 3))
        dproj[..., 0, 0] = dproj[..., 1, 1] = 1.0 / z
        dproj[..., :, 2] = -p_FinC_fej[..., :2] / (z * z)[..., None]
        Hc = distort_jacobian(self.intr, xy).reshape(B, n, 2, 2) @ dproj
        H_f = Hc @ (self.R_ItoC @ R_fej)
        H_clone = np.concatenate([Hc @ self.R_ItoC @ skew(p_FinI_fej), -H_f], axis=3)  # (B, n, 2, 6)
        onehot = np.zeros((B, n, len(self.clones)))
        np.put_along_axis(onehot, J[..., None], 1.0, axis=2)
        H_x = np.zeros((B, 2 * n, len(self.cov)))
        H_x[:, :, self.clone_off:] = np.einsum("bmrk,bmc->bmrck", H_clone, onehot).reshape(B, 2 * n, -1)
        Q = np.linalg.qr(H_f.reshape(B, 2 * n, 3), mode="complete")[0][..., 3:]  # left nullspace of H_f
        Qt = np.swapaxes(Q, 1, 2)
        return Qt @ H_x, (Qt @ r[..., None])[..., 0]

    def _msckf_update(self, feats: List[Feature]):
        var = self.cfg.sigma_pix ** 2
        by_time = {c.t: j for j, c in enumerate(self.clones)}
        self._R = quat_to_rot(np.array([c.q for c in self.clones]))
        self._R_fej = quat_to_rot(np.array([c.q_fej for c in self.clones]))
        self._P = np.array([c.p for c in self.clones])
        self._P_fej = np.array([c.p_fej for c in self.clones])
        groups: Dict[int, list] = {}
        for f in feats:
            obs = sorted(((by_time[t], u, v) for t, u, v in f.obs if t in by_time),
                         key=lambda o: self.clones[o[0]].slot)
            if len(obs) >= 2:
                groups.setdefault(len(obs), []).append(obs)
        Hs, rs = [], []
        for n, items in sorted(groups.items()):
            arr = np.array(items)  # (B, n, 3): clone, u, v
            sys = self._feature_systems(arr[..., 0].astype(int), arr[..., 1:])
            if sys is None:
                continue
            H, r = sys
            S = H @ self.cov @ np.swapaxes(H, 1, 2) + var * np.eye(H.shape[1])
            gamma = np.einsum("bi,bi->b", r, np.linalg.solve(S, r[..., None])[..., 0])
            keep = gamma < self.cfg.chi2_mult * chi2_95(2 * n - 3)
            Hs.append(H[keep].reshape(-1, H.shape[2]))
            rs.append(r[keep].reshape(-1))
        if not Hs or not sum(len(r) for r in rs):
            return
        H, r = np.concatenate(Hs), np.concatenate(rs)
        if len(r) > H.shape[1]:  # compress: the same update from at most D rows
            Q, H = np.linalg.qr(H, mode="reduced")
            r = Q.T @ r
        if not self._ekf_update(H, r, var):
            raise CovarianceError(f"covariance diagonal negative after the MSCKF update at t={self.time:.6f}")

    def _select(self, t: float, marg_t: Optional[float]) -> List[Feature]:
        """Tracks that ended before this frame (two or more observations)
        and, with a full window, tracks seen at the oldest clone that
        are still tracked; longest first (ties in first-seen order)."""
        picked = [f for f in self.features.values() if f.obs[-1][0] < t and len(f.obs) >= 2]
        if marg_t is not None:
            picked += [f for f in self.features.values()
                       if f.obs[-1][0] >= t and any(o[0] == marg_t for o in f.obs)]
        return sorted(picked, key=lambda f: -len(f.obs))[: self.cfg.max_msckf_in_update]

    # --- the sensors -------------------------------------------------------

    def feed_imu(self, t: float, w, a):
        self.imu_t.append(float(t))
        self.imu_w.append(np.asarray(w, float))
        self.imu_a.append(np.asarray(a, float))

    def feed_uwb(self, t: float, ranges: Dict[int, float]):
        if not (self.initialized and len(self.anchors_p) and self.distance > self.cfg.min_dist_to_use_uwb):
            return
        if t <= self.last_uwb_t:
            return
        good = {self.slot_of[aid]: d for aid, d in ranges.items() if aid in self.slot_of}
        if good:
            self.uwb_buffer.append((float(t), good))
            self.last_uwb_t = float(t)

    def feed_features(self, t: float, ids, uvs):
        for fid, (u, v) in zip(ids, uvs):
            f = self.features.get(int(fid))
            if f is None:
                f = self.features[int(fid)] = Feature(int(fid))
            f.obs.append((t, float(u), float(v)))
        if not self.initialized or t <= self.time:
            return
        sets = [s for s in self.uwb_buffer if s[0] < t]
        if len(sets) > UWB_SETS_PER_FRAME:
            raise NotImplementedError("more range sets than a frame takes at once")
        for t_u, ranges in sets:
            if t_u > self.time:
                self._propagate(t_u)
            self._uwb_update(ranges)
            self.q_fej, self.p_fej, self.v_fej = self.q.copy(), self.p.copy(), self.v.copy()
        self.uwb_buffer = [s for s in self.uwb_buffer if s[0] >= t]
        self._propagate(t)
        self._clone()
        full = len(self.clones) > self.cfg.max_clones
        used = self._select(t, self.clones[0].t if full else None)
        self._msckf_update(used)
        for f in used:
            del self.features[f.fid]
        if full:
            marg_t = self._marginalize_oldest()
            for fid in list(self.features):
                f = self.features[fid]
                f.obs = [o for o in f.obs if o[0] >= marg_t + 1e-9]
                if not f.obs:
                    del self.features[fid]
        if self.last_p is not None:
            self.distance += float(np.linalg.norm(self.p - self.last_p))
        self.last_p = self.p.copy()

    # --- what the check compares ------------------------------------------

    def row(self) -> np.ndarray:
        """q p v bg ba, then the anchors' positions, gammas and alphas and
        the lever arm."""
        return np.concatenate([self.q, self.p, self.v, self.bg, self.ba, self.anchors_p.reshape(-1), self.gamma,
                               self.alpha, self.lever])

    def final(self) -> dict:
        """The whole state, by name, its covariance ordered
        [imu | lever arm | clones oldest first | anchors]."""
        n_lever = 0 if self.lever_off is None else 3
        order = np.r_[0:15, 15:15 + n_lever, self.clone_off:len(self.cov), self.anchor_off:self.clone_off]
        cl = self.clones
        return {"q": self.q, "p": self.p, "v": self.v, "bg": self.bg, "ba": self.ba, "q_fej": self.q_fej,
                "p_fej": self.p_fej, "v_fej": self.v_fej, "clones_t": np.array([c.t for c in cl]),
                "clones_q": np.array([c.q for c in cl]), "clones_p": np.array([c.p for c in cl]),
                "clones_q_fej": np.array([c.q_fej for c in cl]), "clones_p_fej": np.array([c.p_fej for c in cl]),
                "anchors_p": self.anchors_p.copy(), "anchors_gamma": self.gamma.copy(),
                "anchors_alpha": self.alpha.copy(), "uwb_p_IinU": self.lever.copy(),
                "cov": self.cov[np.ix_(order, order)]}

"""A plain monocular MSCKF with SLAM landmarks and online camera
calibration (OpenVINS's `VioManager` with `UpdaterMSCKF`, `UpdaterSLAM`
and `StateHelper`), in NumPy float64, written for the benchmark's check
from the published method. It imports nothing of the estimator it judges;
it builds on the corridor reference (`uvio.py`) for RK4, the closed-form
(ACI2) transition, the triangulation and the chi2 quantiles.

It runs one radial-tangential camera with its extrinsics, intrinsics and
time offset estimated, GLOBAL_3D MSCKF features and
ANCHORED_MSCKF_INVERSE_DEPTH SLAM landmarks, RK4 with first-estimate
Jacobians, no IMU intrinsics and no ZUPT (`supported()` names what it
does not follow). The state starts from the truth.

The error state is kept the plain way, grown and shrunk as OpenVINS's
`StateHelper` does: `[imu (15) | dt (1) | extrinsics theta p (6) |
intrinsics (8) | clones (6 each, oldest first) | landmarks (3 each, in
the order they entered)]`. A frame at time t (camera clock):

  1. its tracks enter the feature store;
  2. landmarks whose track ended before the oldest live time are
     marginalized;
  3. MSCKF features: tracks that ended and, with a full window, tracks
     seen at the oldest clone and still tracked, without landmarks and
     this frame's SLAM candidates, longest first, at most
     `max_msckf_in_update`; SLAM candidates: once `dt_slam_delay` has
     passed since the start and the window is full, tracks seen at the
     oldest clone, still tracked and seen at `max_clones` of the live
     times, longest first, at most the free slots and 8;
  4. propagation over the IMU samples from the state's time plus the
     last time offset to t plus the current one, and a clone whose
     covariance carries the time offset's Jacobian `[w; v]`;
  5. the MSCKF update (nullspace projection, 95% chi2, one update);
  6. the landmarks' update from their observations not yet used, each
     gated at 95% chi2 of its rows, one update of all that pass;
  7. each candidate's delayed initialization, one after the other:
     triangulation, the stacked system split by QR into 3 rows that fix
     the landmark (`initialize_invertible`) and the rest, gated and
     applied as an update; the anchor is the newest clone;
  8. with a full window, landmarks anchored at the oldest clone move to
     the newest (`change_anchors`), and the oldest clone goes;
  9. landmarks that failed their gate twice are marginalized.

Where the port makes its own documented choices, this follows them:

  * among tied SLAM candidates the oldest track is promoted (OpenVINS
    takes the newest), and every landmark is updated every frame
    (`max_slam_in_update` is not applied);
  * a landmark's update takes at most 4 of its observations, the first
    in the order of the clones' ring slots (the port's static backlog);
  * a landmark dies when its track has left the window, not the first
    frame it is missed, and after 2 failed gates;
  * the delayed initialization's gate counts every row of the stacked
    system as a degree of freedom (OpenVINS's `res.rows()`);
  * a landmark's Jacobian through its anchor has no extrinsic column;
  * a feature's Gauss-Newton frame is its observation at the lowest
    ring slot, undistortion is 20 fixed-point steps, and triangulation
    takes at most 40 times the largest baseline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .config import EstimatorConfig
from .geometry import EYE3, distort, distort_jacobian, error_quat, quat_mul, quat_to_rot, skew, undistort
from .uvio import Clone, CovarianceError, Feature, UVio, chi2_95, rk4

CALIB = 15  # dt (1), extrinsics (6), intrinsics (8)
SLAM_FAIL_MARG = 2  # failed gates before a landmark is marginalized
SLAM_INIT_PER_FRAME = 8
SLAM_OBS = 4  # observations a landmark's update takes at most
CALIB_PRIOR = np.array([0.01] + [0.005] * 3 + [0.015] * 3 + [1.0] * 4 + [0.005] * 4) ** 2
GT_PRIOR = np.repeat([0.017, 0.05, 0.01, 0.02, 0.02], 3) ** 2


def rot_to_quat(R):
    """The JPL quaternion of R (`geometry.quat_to_rot`'s inverse)."""
    t = np.trace(R)
    if t > 0:
        w = 0.5 * np.sqrt(1.0 + t)
        q = np.array([(R[1, 2] - R[2, 1]) / (4 * w), (R[2, 0] - R[0, 2]) / (4 * w), (R[0, 1] - R[1, 0]) / (4 * w), w])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        v = np.zeros(3)
        v[i] = 0.5 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        v[j] = (R[i, j] + R[j, i]) / (4 * v[i])
        v[k] = (R[i, k] + R[k, i]) / (4 * v[i])
        q = np.array([*v, (R[j, k] - R[k, j]) / (4 * v[i])])
    return q / np.linalg.norm(q) * (1.0 if q[3] >= 0 else -1.0)


def intrinsics_jacobian(intr, xy):
    """d pixel / d (fx fy cx cy k1 k2 p1 p2) at normalized points, (N, 2, 8)."""
    fx, fy, _, _, k1, k2, p1, p2 = intr
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    J = np.zeros((len(x), 2, 8))
    J[:, 0, 0], J[:, 0, 2] = xd, 1.0
    J[:, 1, 1], J[:, 1, 3] = yd, 1.0
    J[:, 0, 4:] = fx * np.stack([x * r2, x * r2 * r2, 2.0 * x * y, r2 + 2.0 * x * x], axis=1)
    J[:, 1, 4:] = fy * np.stack([y * r2, y * r2 * r2, r2 + 2.0 * y * y, 2.0 * x * y], axis=1)
    return J


# --- anchored inverse depth (alpha, beta, rho) in the anchor camera ---------

def to_point(val):
    a, b, rho = val
    return np.array([a / rho, b / rho, 1.0 / rho])


def to_value(p):
    return np.array([p[0] / p[2], p[1] / p[2], 1.0 / p[2]])


def d_point_d_value(val):
    a, b, rho = val
    return np.array([[1.0 / rho, 0.0, -a / rho ** 2], [0.0, 1.0 / rho, -b / rho ** 2], [0.0, 0.0, -1.0 / rho ** 2]])


def d_value_d_point(p):
    x, y, z = p
    return np.array([[1.0 / z, 0.0, -x / z ** 2], [0.0, 1.0 / z, -y / z ** 2], [0.0, 0.0, -1.0 / z ** 2]])


@dataclasses.dataclass
class Landmark:
    fid: int
    val: np.ndarray  # (alpha, beta, rho) in the anchor camera
    fej: np.ndarray
    anchor: Clone
    fails: int = 0
    consumed: float = -np.inf  # the newest observation time already used


class SlamVio(UVio):
    """The estimator. Feed it as the program is fed: `feed_imu`,
    `feed_features`, after `initialize_with_gt`."""

    def __init__(self, cfg: EstimatorConfig):
        missing = supported(cfg)
        if missing:
            raise NotImplementedError(f"the plain reference does not implement: {', '.join(missing)}")
        r = cfg.raw
        self.cfg = cfg
        cam = cfg.cameras[0]
        self.intr = cam.intrinsics.copy()
        self.q_c = rot_to_quat(cam.R_ItoC)
        self.p_c = cam.p_IinC.copy()
        self.dt = float(r.get("calib_camimu_dt", 0.0))
        self.g = np.array([0.0, 0.0, cfg.gravity_mag])
        self.noise = np.array([cfg.sigma_w ** 2] * 3 + [cfg.sigma_a ** 2] * 3 + [cfg.sigma_wb ** 2] * 3
                              + [cfg.sigma_ab ** 2] * 3)
        self.ring = cfg.max_clones + 1
        self.max_slam = int(r.get("max_slam", 0))
        self.dt_slam_delay = float(r.get("dt_slam_delay", 2.0))
        self.clone_off = 15 + CALIB
        self.cov = np.zeros((self.clone_off, self.clone_off))
        self.cov[15:30, 15:30] = np.diag(CALIB_PRIOR)
        self.clones: List[Clone] = []
        self.head = -1
        self.features: Dict[int, Feature] = {}
        self.lms: List[Landmark] = []
        self.imu_t, self.imu_w, self.imu_a = [], [], []
        self.initialized = False
        self.dt_last: Optional[float] = None

    # --- the state ---------------------------------------------------------

    def initialize_with_gt(self, t, q, p, v, bg, ba):
        self.time = self.startup = float(t)
        self.q, self.p, self.v = (np.asarray(x, float).copy() for x in (q, p, v))
        self.bg, self.ba = np.asarray(bg, float).copy(), np.asarray(ba, float).copy()
        self.q_fej, self.p_fej, self.v_fej = self.q.copy(), self.p.copy(), self.v.copy()
        self.cov[:15, :] = 0.0
        self.cov[:, :15] = 0.0
        self.cov[:15, :15] = np.diag(GT_PRIOR)
        self.initialized = True

    @property
    def lm_off(self) -> int:
        return self.clone_off + 6 * len(self.clones)

    def _lm_cols(self, i: int) -> slice:
        return slice(self.lm_off + 3 * i, self.lm_off + 3 * i + 3)

    def _clone_cols(self, j: int) -> slice:
        return slice(self.clone_off + 6 * j, self.clone_off + 6 * j + 6)

    def _inject(self, dx):
        self.q = quat_mul(error_quat(dx[0:3]), self.q)
        self.p = self.p + dx[3:6]
        self.v = self.v + dx[6:9]
        self.bg = self.bg + dx[9:12]
        self.ba = self.ba + dx[12:15]
        self.dt += dx[15]
        self.q_c = quat_mul(error_quat(dx[16:19]), self.q_c)
        self.p_c = self.p_c + dx[19:22]
        self.intr = self.intr + dx[22:30]
        for j, c in enumerate(self.clones):
            d = dx[self._clone_cols(j)]
            c.q = quat_mul(error_quat(d[:3]), c.q)
            c.p = c.p + d[3:]
        for i, lm in enumerate(self.lms):
            lm.val = lm.val + dx[self._lm_cols(i)]

    def _update(self, H, r, where: str):
        """One EKF update from the stacked rows; more rows than the state
        has are first compressed by QR (the same update, the noise being
        isotropic)."""
        if len(r) > H.shape[1]:
            Q, H = np.linalg.qr(H, mode="reduced")
            r = Q.T @ r
        if not self._ekf_update(H, r, self.cfg.sigma_pix ** 2):
            raise CovarianceError(f"covariance diagonal negative after the {where} at t={self.time:.6f}")

    def _remove(self, idx):
        keep = np.setdiff1d(np.arange(len(self.cov)), idx)
        self.cov = self.cov[np.ix_(keep, keep)]

    # --- propagation and cloning --------------------------------------------

    def _propagate_clone(self, t: float):
        """To camera time t over the IMU clock's [time + dt_last, t + dt],
        then the clone, with the time offset's Jacobian in its rows."""
        dt_now = self.dt
        if self.dt_last is None:
            self.dt_last = dt_now
        t0 = self.time + self.dt_last
        tt, ww, aa = self._imu_window(t0, max(t + dt_now, t0 + 1e-9))
        dt_all = np.diff(np.asarray(tt))
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
        if len(use) and use[0] == 0:  # the first interval at the first estimates
            R_k[0], p_k[0], v_k[0] = quat_to_rot(self.q_fej), self.p_fej, self.v_fej
        d = dt_all[use]
        F, G = self._transitions(R_k, p_k, v_k, Rs[1:], np.array(ps[1:]), np.array(vs[1:]),
                                 0.5 * (w[use] + w[use + 1]), 0.5 * (a[use] + a[use + 1]), d)
        Q = (G * (self.noise[None, :] / d[:, None])[:, None, :]) @ np.swapaxes(G, 1, 2)
        Phi, Qd = np.eye(15), np.zeros((15, 15))
        for i in range(len(d)):
            Phi = F[i] @ Phi
            Qd = F[i] @ Qd @ F[i].T + Q[i]
        rows = Phi @ self.cov[:15, :]
        self.cov[:15, :] = rows
        self.cov[:, :15] = rows.T
        block = rows[:, :15] @ Phi.T + Qd
        self.cov[:15, :15] = 0.5 * (block + block.T)
        self.q, self.p, self.v = qs[-1], ps[-1], vs[-1]
        self.q_fej, self.p_fej, self.v_fej = self.q.copy(), self.p.copy(), self.v.copy()
        self.time = float(t)
        self.dt_last = dt_now
        # the clone, inserted after the last clone
        D, o = len(self.cov), self.lm_off
        J = np.zeros((6, D))
        J[0:3, 0:3] = J[3:6, 3:6] = EYE3
        J[0:3, 15], J[3:6, 15] = w[-1], self.v
        rows = J @ self.cov
        order = np.r_[0:o, D:D + 6, o:D]
        cov = np.zeros((D + 6, D + 6))
        cov[:D, :D] = self.cov
        cov[D:, :D] = rows
        cov[:D, D:] = rows.T
        cov[D:, D:] = rows @ J.T
        self.cov = cov[np.ix_(order, order)]
        self.head = 0 if self.head < 0 else (self.head + 1) % self.ring
        self.clones.append(Clone(self.time, self.q.copy(), self.p.copy(), self.q.copy(), self.p.copy(), self.head))

    # --- the camera ----------------------------------------------------------

    def _cam(self):
        R_ItoC = quat_to_rot(self.q_c)
        return R_ItoC, self.p_c, -R_ItoC.T @ self.p_c

    def _cam_pose(self, c: Clone, fej: bool = False):
        """(R_GtoC, p_CinG, R_GtoI) of clone c, at its first estimate with
        `fej`."""
        R_ItoC, _, p_CinI = self._cam()
        R_GtoI = quat_to_rot(c.q_fej if fej else c.q)
        return R_ItoC @ R_GtoI, (c.p_fej if fej else c.p) + R_GtoI.T @ p_CinI, R_GtoI

    def _systems(self, p_f, J, uv):
        """Features at global points p_f (B, 3), each seen at the clones J
        (B, n) (indices) at pixels uv (B, n, 2): (H_x (B, 2n, D) with the
        clone and calibration columns, H_f (B, 2n, 3) over p_f, r (B,
        2n)). The prediction at the current estimates; the Jacobians at the
        clones' first estimates, the distortion's and the intrinsics' at the
        current point."""
        B, n = J.shape
        R_ItoC, p_IinC, _ = self._cam()
        R, Rf, P, Pf = self._R[J], self._R_fej[J], self._P[J], self._P_fej[J]
        p_FinC = np.einsum("ij,bmj->bmi", R_ItoC, np.einsum("bmij,bmj->bmi", R, p_f[:, None] - P)) + p_IinC
        z = p_FinC[..., 2]
        xy = (p_FinC[..., :2] / np.where(np.abs(z) < 1e-6, 1e-6, z)[..., None]).reshape(-1, 2)
        r = (uv.reshape(-1, 2) - distort(self.intr, xy)).reshape(B, 2 * n)
        p_FinI_f = np.einsum("bmij,bmj->bmi", Rf, p_f[:, None] - Pf)
        p_FinC_f = p_FinI_f @ R_ItoC.T + p_IinC
        zf = p_FinC_f[..., 2]
        zf = np.where(np.abs(zf) < 1e-6, 1e-6, zf)
        dproj = np.zeros((B, n, 2, 3))
        dproj[..., 0, 0] = dproj[..., 1, 1] = 1.0 / zf
        dproj[..., :, 2] = -p_FinC_f[..., :2] / (zf * zf)[..., None]
        Hcam = distort_jacobian(self.intr, xy).reshape(B, n, 2, 2) @ dproj
        H_f = Hcam @ R_ItoC @ Rf
        H = np.zeros((B, n, 2, len(self.cov)))
        H[..., 16:19] = Hcam @ skew(p_FinC_f - p_IinC)
        H[..., 19:22] = Hcam
        H[..., 22:30] = intrinsics_jacobian(self.intr, xy).reshape(B, n, 2, 8)
        H_clone = np.concatenate([Hcam @ R_ItoC @ skew(p_FinI_f), -H_f], axis=3)  # (B, n, 2, 6)
        cols = self.clone_off + 6 * J[..., None] + np.arange(6)  # (B, n, 6)
        H[np.arange(B)[:, None, None, None], np.arange(n)[None, :, None, None], np.arange(2)[None, None, :, None],
          cols[:, :, None, :]] = H_clone
        return H.reshape(B, 2 * n, -1), H_f.reshape(B, 2 * n, 3), r

    def _system(self, p_f, J, uv):
        """`_systems` of one feature."""
        H, H_f, r = self._systems(p_f[None], J[None], uv[None])
        return H[0], H_f[0], r[0]

    def _poses(self):
        """The clones' rotations and positions, current and first estimates,
        for `_systems`."""
        self._R = quat_to_rot(np.array([c.q for c in self.clones]))
        self._R_fej = quat_to_rot(np.array([c.q_fej for c in self.clones]))
        self._P = np.array([c.p for c in self.clones])
        self._P_fej = np.array([c.p_fej for c in self.clones])

    def _observations(self, f: Feature, after: float = -np.inf):
        """(clone indices, pixels) of f's observations at live clones later
        than `after`, in ring-slot order."""
        by_time = {c.t: j for j, c in enumerate(self.clones)}
        obs = sorted(((by_time[t], u, v) for t, u, v in f.obs if t in by_time and t > after),
                     key=lambda o: self.clones[o[0]].slot)
        return np.array([o[0] for o in obs], int), np.array([[o[1], o[2]] for o in obs]).reshape(-1, 2)

    def _cam_poses(self, J):
        """(R_GtoC, p_CinG) of the clones J (any shape), current values."""
        R_ItoC, _, p_CinI = self._cam()
        return R_ItoC @ self._R[J], self._P[J] + np.einsum("...ji,j->...i", self._R[J], p_CinI)

    def _triangulate_one(self, J, uv):
        R_GtoC, p_CinG = self._cam_poses(J)
        p, ok = self._triangulate(undistort(self.intr, uv)[None], R_GtoC[None], p_CinG[None])
        return p[0], bool(ok[0])

    # --- MSCKF ----------------------------------------------------------------

    def _gate(self, H, r, dof):
        """Which of the stacked systems (B, m, D), (B, m) pass the 95% chi2
        gate of `dof` (B,) degrees of freedom."""
        S = H @ self.cov @ np.swapaxes(H, 1, 2) + self.cfg.sigma_pix ** 2 * np.eye(H.shape[1])
        gamma = np.einsum("bi,bi->b", r, np.linalg.solve(S, r[..., None])[..., 0])
        return gamma < self.cfg.chi2_mult * np.array([chi2_95(int(d)) for d in dof])

    def _msckf(self, feats: List[Feature]):
        groups: Dict[int, list] = {}
        for f in feats:
            J, uv = self._observations(f)
            if len(J) >= 2:
                groups.setdefault(len(J), []).append((J, uv))
        Hs, rs = [], []
        for n, items in sorted(groups.items()):
            J = np.array([j for j, _ in items])
            uv = np.array([u for _, u in items])
            R_GtoC, p_CinG = self._cam_poses(J)
            p_f, ok = self._triangulate(undistort(self.intr, uv.reshape(-1, 2)).reshape(len(J), n, 2), R_GtoC, p_CinG)
            if not ok.any():
                continue
            H, H_f, r = self._systems(p_f[ok], J[ok], uv[ok])
            Q = np.swapaxes(np.linalg.qr(H_f, mode="complete")[0][..., 3:], 1, 2)  # the left nullspace of H_f
            H, r = Q @ H, (Q @ r[..., None])[..., 0]
            keep = self._gate(H, r, np.full(len(r), r.shape[1]))
            Hs.append(H[keep].reshape(-1, H.shape[2]))
            rs.append(r[keep].reshape(-1))
        if Hs and sum(len(r) for r in rs):
            self._update(np.concatenate(Hs), np.concatenate(rs), "MSCKF update")

    # --- SLAM -------------------------------------------------------------------

    def _anchored(self, lm: Landmark):
        """(p_FinG, J_rep = d p_FinG / d value, H_anc = d p_FinG / d
        (anchor theta, p)): the current point, re-expressed in the anchor's
        first-estimate frame for the Jacobians."""
        R_ItoC, p_IinC, _ = self._cam()
        R_GtoC, p_CinG, _ = self._cam_pose(lm.anchor)
        p_G = R_GtoC.T @ to_point(lm.val) + p_CinG
        Rf = quat_to_rot(lm.anchor.q_fej)
        p_A = R_ItoC @ Rf @ (p_G - lm.anchor.p_fej) + p_IinC
        J_rep = Rf.T @ R_ItoC.T @ d_point_d_value(to_value(p_A))
        H_anc = np.concatenate([-Rf.T @ skew(R_ItoC.T @ (p_A - p_IinC)), EYE3], axis=1)
        return p_G, J_rep, H_anc

    def _slam_update(self, obs) -> set:
        """The landmarks' update from `obs` {landmark index: (J, uv)};
        returns the indices whose gate failed."""
        groups: Dict[int, list] = {}
        for i, (J, uv) in obs.items():
            groups.setdefault(min(len(J), SLAM_OBS), []).append((i, J[:SLAM_OBS], uv[:SLAM_OBS]))
        Hs, rs, failed = [], [], set()
        for n, items in sorted(groups.items()):
            idx = [i for i, _, _ in items]
            p_G, J_rep, H_anc = zip(*[self._anchored(self.lms[i]) for i in idx])
            H, H_f, r = self._systems(np.array(p_G), np.array([J for _, J, _ in items]),
                                      np.array([uv for _, _, uv in items]))
            for b, i in enumerate(idx):
                a = self.clones.index(self.lms[i].anchor)
                H[b][:, self._clone_cols(a)] += H_f[b] @ H_anc[b]
                H[b][:, self._lm_cols(i)] = H_f[b] @ J_rep[b]
            keep = self._gate(H, r, np.full(len(r), r.shape[1]))
            failed |= {i for i, k in zip(idx, keep) if not k}
            Hs.append(H[keep].reshape(-1, H.shape[2]))
            rs.append(r[keep].reshape(-1))
        if sum(len(r) for r in rs):
            self._update(np.concatenate(Hs), np.concatenate(rs), "SLAM update")
        return failed

    def _slam_init(self, cands: List[Feature]) -> List[int]:
        """Delayed initialization of `cands`, one after the other, anchored
        at the newest clone; returns the feature ids that entered."""
        var = self.cfg.sigma_pix ** 2
        R_ItoC, p_IinC, _ = self._cam()
        anchor = self.clones[-1]
        a = len(self.clones) - 1
        R_GtoC_a, p_CinG_a, _ = self._cam_pose(anchor)
        R_GtoC_af, _, Rf = self._cam_pose(anchor, fej=True)
        systems = []
        for f in cands:  # every system from the state before the first enters
            J, uv = self._observations(f)
            p_f, ok = self._triangulate_one(J, uv) if len(J) >= 2 else (np.zeros(3), False)
            val0 = to_value(R_GtoC_a @ (p_f - p_CinG_a)) if ok else np.zeros(3)
            ok = ok and len(J) >= 3 and 1.0 / val0[2] > 0.1
            if not ok:
                systems.append(None)
                continue
            p_A = R_GtoC_af @ (p_f - anchor.p_fej) + p_IinC
            H, H_fG, r = self._system(p_f, J, uv)
            H[:, self._clone_cols(a)] += H_fG @ np.concatenate([-Rf.T @ skew(R_ItoC.T @ (p_A - p_IinC)), EYE3], axis=1)
            H_f = H_fG @ R_GtoC_af.T @ d_point_d_value(to_value(p_A))
            Q, Rq = np.linalg.qr(H_f, mode="complete")
            systems.append((f.fid, val0, Rq[:3], Q.T @ H, Q.T @ r))
        entered = []
        for sysm in systems:
            if sysm is None:
                continue
            fid, val0, H_L, H, r = sysm
            D = len(self.cov)
            H = np.concatenate([H, np.zeros((len(H), D - H.shape[1]))], axis=1)  # landmarks added meanwhile
            H_R, r_i, H_up, r_up = H[:3], r[:3], H[3:], r[3:]
            S = H_up @ self.cov @ H_up.T + var * np.eye(len(r_up))
            if not (r_up @ np.linalg.solve(S, r_up) < self.cfg.chi2_mult * chi2_95(len(r))):
                continue
            if not abs(np.prod(np.diag(H_L))) > 1e-9:
                continue
            H_Linv = np.linalg.inv(H_L)
            M_a = self.cov @ H_R.T
            cross = -M_a @ H_Linv.T
            cov = np.zeros((D + 3, D + 3))
            cov[:D, :D] = self.cov
            cov[:D, D:] = cross
            cov[D:, :D] = cross.T
            cov[D:, D:] = H_Linv @ (H_R @ M_a + var * EYE3) @ H_Linv.T
            self.cov = cov
            self.lms.append(Landmark(fid, val0 + H_Linv @ r_i, val0.copy(), anchor))
            self._update(np.concatenate([H_up, np.zeros((len(r_up), 3))], axis=1), r_up, "SLAM initialization")
            entered.append(fid)
        return entered

    def _change_anchors(self, old: Clone, new: Clone):
        """Landmarks anchored at `old` move to `new`: the value exactly, the
        covariance to first order at the first estimates."""
        moved = [i for i, lm in enumerate(self.lms) if lm.anchor is old]
        if not moved:
            return
        R_ItoC, p_IinC, _ = self._cam()
        R_a, p_a, _ = self._cam_pose(old)
        R_n, p_n, _ = self._cam_pose(new)
        R_af, p_af, R_Iaf = self._cam_pose(old, fej=True)
        R_nf, p_nf, _ = self._cam_pose(new, fej=True)
        jo, jn = self.clones.index(old), self.clones.index(new)
        D = len(self.cov)
        T = np.eye(D)
        for i in moved:
            lm = self.lms[i]
            p_G = R_a.T @ to_point(lm.val) + p_a
            old_lin, new_lin = R_af @ (p_G - p_af), R_nf @ (p_G - p_nf)
            Jn = d_value_d_point(new_lin)
            rows = np.zeros((3, D))
            rows[:, self._lm_cols(i)] = Jn @ R_nf @ R_af.T @ d_point_d_value(to_value(old_lin))
            rows[:, self._clone_cols(jo)] = Jn @ R_nf @ np.concatenate(
                [-R_Iaf.T @ skew(R_ItoC.T @ (old_lin - p_IinC)), EYE3], axis=1)
            rows[:, self._clone_cols(jn)] = Jn @ np.concatenate(
                [R_ItoC @ skew(R_ItoC.T @ (new_lin - p_IinC)), -R_nf], axis=1)
            T[self._lm_cols(i)] = rows
            lm.val = to_value(R_n @ (p_G - p_n))
            lm.fej = to_value(R_nf @ (R_af.T @ to_point(lm.fej) + p_af - p_nf))
            lm.anchor = new
        self.cov = T @ self.cov @ T.T

    def _free(self, i: int):
        s = self._lm_cols(i)
        self._remove(np.arange(s.start, s.stop))
        del self.lms[i]

    # --- the sensors --------------------------------------------------------------

    def feed_features(self, t: float, ids, uvs):
        for fid, (u, v) in zip(ids, uvs):
            f = self.features.get(int(fid))
            if f is None:
                f = self.features[int(fid)] = Feature(int(fid))
            f.obs.append((t, float(u), float(v)))
        if not self.initialized or t <= self.time:
            return
        live = [c.t for c in self.clones] + [t]
        full = len(live) > self.cfg.max_clones
        marg_t = live[0] if full else None
        # landmarks whose track has left the window
        horizon = live[0]
        for i in reversed(range(len(self.lms))):
            f = self.features.get(self.lms[i].fid)
            if f is None or f.obs[-1][0] < horizon:
                self.features.pop(self.lms[i].fid, None)
                self._free(i)
        slam_ids = {lm.fid for lm in self.lms}
        cands = self._candidates(t, live, marg_t, slam_ids)
        cand_ids = {f.fid for f in cands}
        feats = self._select(t, marg_t)
        feats = [f for f in feats if f.fid not in slam_ids and f.fid not in cand_ids]
        feats = sorted(feats, key=lambda f: -len(f.obs))[: self.cfg.max_msckf_in_update]

        self._propagate_clone(t)
        self._poses()
        self._msckf(feats)
        self._poses()
        obs = {}
        for i, lm in enumerate(self.lms):
            J, uv = self._observations(self.features[lm.fid], lm.consumed)
            if len(J):
                obs[i] = (J, uv)
        failed = self._slam_update(obs) if obs else set()
        self._poses()
        entered = self._slam_init(cands) if cands else []
        if full:
            self._change_anchors(self.clones[0], self.clones[-1])
            self._remove(np.arange(self.clone_off, self.clone_off + 6))
            self.clones.pop(0)

        for f in feats:
            del self.features[f.fid]
        n_before = len(self.lms) - len(entered)
        if obs:
            for i in reversed(range(n_before)):
                lm = self.lms[i]
                lm.consumed = t
                if i in failed:
                    lm.fails += 1
                    if lm.fails >= SLAM_FAIL_MARG:
                        self.features.pop(lm.fid, None)
                        self._free(i)
        for lm in self.lms:
            if lm.fid in entered:
                lm.consumed = t
        if full:
            for fid in list(self.features):
                f = self.features[fid]
                f.obs = [o for o in f.obs if o[0] >= marg_t + 1e-9]
                if not f.obs:
                    del self.features[fid]

    def _select(self, t: float, marg_t: Optional[float]) -> List[Feature]:
        picked = [f for f in self.features.values() if f.obs[-1][0] < t and len(f.obs) >= 2]
        if marg_t is not None:
            picked += [f for f in self.features.values()
                       if f.obs[-1][0] >= t and any(o[0] == marg_t for o in f.obs)]
        return picked

    def _candidates(self, t, live, marg_t, slam_ids) -> List[Feature]:
        free = self.max_slam - len(self.lms)
        if self.max_slam == 0 or marg_t is None or t - self.startup < self.dt_slam_delay or free <= 0:
            return []
        window = set(live)
        out = [f for f in self.features.values()
               if f.fid not in slam_ids and f.obs[-1][0] >= t and any(o[0] == marg_t for o in f.obs)
               and len({o[0] for o in f.obs} & window) >= self.cfg.max_clones]
        out = sorted(out, key=lambda f: -len(f.obs))
        return out[: min(free, SLAM_INIT_PER_FRAME)]

    # --- what the check compares ------------------------------------------------

    def row(self) -> np.ndarray:
        """q p v bg ba, the time offset, the extrinsics q_ItoC p_IinC and
        the intrinsics."""
        return np.concatenate([self.q, self.p, self.v, self.bg, self.ba, [self.dt], self.q_c, self.p_c, self.intr])

    def landmarks(self) -> Dict[int, tuple]:
        """{feature id: (value, its anchor clone's time)}."""
        return {lm.fid: (lm.val.copy(), lm.anchor.t) for lm in self.lms}

    def final(self) -> dict:
        """The whole state by name, its covariance ordered [imu | calib |
        clones oldest first | landmarks by feature id]."""
        by_id = np.argsort([lm.fid for lm in self.lms], kind="stable")
        order = np.r_[0:self.lm_off, [self.lm_off + 3 * i + k for i in by_id for k in range(3)]].astype(int)
        cl = self.clones
        lms = [self.lms[i] for i in by_id]
        return {"q": self.q, "p": self.p, "v": self.v, "bg": self.bg, "ba": self.ba, "q_fej": self.q_fej,
                "p_fej": self.p_fej, "v_fej": self.v_fej, "calib_dt": np.array([self.dt]), "calib_q": self.q_c,
                "calib_p": self.p_c, "calib_intr": self.intr, "clones_t": np.array([c.t for c in cl]),
                "clones_q": np.array([c.q for c in cl]), "clones_p": np.array([c.p for c in cl]),
                "clones_q_fej": np.array([c.q_fej for c in cl]), "clones_p_fej": np.array([c.p_fej for c in cl]),
                "slam_id": np.array([lm.fid for lm in lms], dtype=np.int64),
                "slam_anchor_t": np.array([lm.anchor.t for lm in lms]),
                "slam_p": np.array([lm.val for lm in lms]).reshape(-1, 3),
                "slam_p_fej": np.array([lm.fej for lm in lms]).reshape(-1, 3),
                "cov": self.cov[np.ix_(order, order)]}


def supported(cfg: EstimatorConfig) -> List[str]:
    """The settings `SlamVio` does not follow (empty when it follows the
    configuration whole)."""
    r = cfg.raw
    out = [k for k in ("calib_imu_intrinsics", "calib_imu_g_sensitivity", "try_zupt", "use_stereo") if r.get(k, False)]
    out += [k for k in ("calib_cam_extrinsics", "calib_cam_intrinsics", "calib_cam_timeoffset") if not r.get(k, False)]
    if str(r.get("integration", "rk4")).lower() != "rk4":
        out.append("integration")
    if not r.get("use_fej", True):
        out.append("use_fej")
    if str(r.get("feat_rep_msckf", "GLOBAL_3D")) != "GLOBAL_3D":
        out.append("feat_rep_msckf")
    if int(r.get("max_slam", 0)) > 0 and str(r.get("feat_rep_slam", "")) != "ANCHORED_MSCKF_INVERSE_DEPTH":
        out.append("feat_rep_slam")
    if len(cfg.cameras) != 1 or cfg.cameras[0].model != "radtan":
        out.append("cameras")
    if cfg.anchors:
        out.append("anchors")
    return out

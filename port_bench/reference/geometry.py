"""Rotations and the camera, in NumPy float64, as OpenVINS writes them.

Quaternions are JPL, `[qx, qy, qz, qw]` with `qw >= 0`, and `q_AtoB`
rotates A into B: `R(q) = (2 qw^2 - 1) I - 2 qw [qv]x + 2 qv qv^T`, and
`R(q (x) p) = R(q) R(p)`. An error angle `dtheta` acts on the left:
`R_true = exp(-[dtheta]x) R`, applied as `q <- [dtheta/2, 1] (x) q`.
"""

from __future__ import annotations

import numpy as np

EYE3 = np.eye(3)


def skew(v):
    """[v]x of one vector (3,) or of each of (..., 3)."""
    v = np.asarray(v)
    out = np.zeros(v.shape[:-1] + (3, 3))
    out[..., 0, 1], out[..., 0, 2] = -v[..., 2], v[..., 1]
    out[..., 1, 0], out[..., 1, 2] = v[..., 2], -v[..., 0]
    out[..., 2, 0], out[..., 2, 1] = -v[..., 1], v[..., 0]
    return out


def quat_normalize(q):
    q = q / np.sqrt(q @ q)
    return -q if q[3] < 0 else q


def quat_mul(q, p):
    qx, qy, qz, qw = q
    px, py, pz, pw = p
    return quat_normalize(np.array([qw * px + pw * qx - (qy * pz - qz * py),
                                    qw * py + pw * qy - (qz * px - qx * pz),
                                    qw * pz + pw * qz - (qx * py - qy * px),
                                    qw * pw - (qx * px + qy * py + qz * pz)]))


def quat_to_rot(q):
    """R of one quaternion (4,) or of each of (..., 4)."""
    q = np.asarray(q)
    if q.ndim == 1:
        x, y, z, w = q
        return np.array([[2.0 * (w * w + x * x) - 1.0, 2.0 * (x * y + w * z), 2.0 * (x * z - w * y)],
                         [2.0 * (x * y - w * z), 2.0 * (w * w + y * y) - 1.0, 2.0 * (y * z + w * x)],
                         [2.0 * (x * z + w * y), 2.0 * (y * z - w * x), 2.0 * (w * w + z * z) - 1.0]])
    v, w = q[..., :3], q[..., 3]
    eye = np.broadcast_to(EYE3, q.shape[:-1] + (3, 3))
    return ((2.0 * w * w - 1.0)[..., None, None] * eye - 2.0 * w[..., None, None] * skew(v)
            + 2.0 * v[..., :, None] * v[..., None, :])


def error_quat(dtheta):
    """The quaternion of a small error angle, `[dtheta / 2, 1]` normalized."""
    return quat_normalize(np.concatenate([0.5 * dtheta, [1.0]]))


def omega(w):
    """`Omega(w)` of the JPL kinematics `q' = Omega(w) q / 2`."""
    x, y, z = w
    return np.array([[0.0, z, -y, x], [-z, 0.0, x, y], [y, -x, 0.0, z], [-x, -y, -z, 0.0]])


def jl_so3(w):
    """Left Jacobian of SO(3) of each of (n, 3); the right one is
    `jl_so3(-w)`."""
    t2 = np.sum(w * w, axis=-1)
    small = t2 < 1e-12
    t = np.sqrt(np.where(small, 1.0, t2))
    b = np.where(small, 0.5, (1.0 - np.cos(t)) / np.where(small, 1.0, t2))
    c = np.where(small, 1.0 / 6.0, (t - np.sin(t)) / np.where(small, 1.0, t2 * t))
    W = skew(w)
    return EYE3 + b[..., None, None] * W + c[..., None, None] * (W @ W)


# --- the radial-tangential pinhole camera (OpenVINS `CamRadtan`) ---------

UNDISTORT_ITERS = 20


def distort(intr, xy):
    """Normalized points (N, 2) -> pixels (N, 2)."""
    fx, fy, cx, cy, k1, k2, p1, p2 = intr
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([fx * xd + cx, fy * yd + cy], axis=1)


def distort_jacobian(intr, xy):
    """d pixel / d normalized point, (N, 2, 2)."""
    fx, fy, _, _, k1, k2, p1, p2 = intr
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dr = 2.0 * (k1 + 2.0 * k2 * r2)  # d radial / d(x, y) = dr * (x, y)
    J = np.empty((len(x), 2, 2))
    J[:, 0, 0] = fx * (radial + dr * x * x + 2.0 * p1 * y + 6.0 * p2 * x)
    J[:, 0, 1] = fx * (dr * x * y + 2.0 * p1 * x + 2.0 * p2 * y)
    J[:, 1, 0] = fy * (dr * x * y + 2.0 * p1 * x + 2.0 * p2 * y)
    J[:, 1, 1] = fy * (radial + dr * y * y + 6.0 * p1 * y + 2.0 * p2 * x)
    return J


def undistort(intr, uv):
    """Pixels (N, 2) -> normalized points, by the fixed-point iteration
    `xy <- (pt - tangential(xy)) / radial(xy)` from `pt`, the estimator's
    `UNDISTORT_ITERS` steps of it."""
    fx, fy, cx, cy, k1, k2, p1, p2 = intr
    pt = (uv - np.array([cx, cy])) / np.array([fx, fy])
    x, y = pt[:, 0].copy(), pt[:, 1].copy()
    for _ in range(UNDISTORT_ITERS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        ty = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (pt[:, 0] - tx) / radial, (pt[:, 1] - ty) / radial
    return np.stack([x, y], axis=1)

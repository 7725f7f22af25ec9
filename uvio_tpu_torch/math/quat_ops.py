"""JPL quaternion / SO(3) / SE(3) math core on tensors.

Port of `uvio_tpu/math/quat_ops.py` (Trawny & Roumeliotis TR-2005-002
conventions, as in the reference's `ov_core/src/utils/quat_ops.h`):

  * quaternions are JPL, stored `[x, y, z, w]` with `w >= 0` enforced;
  * `q_GtoI` maps global to local: `R(q_GtoI) @ v_G = v_I`;
  * `R(q) = (2 w^2 - 1) I - 2 w [qv]_x + 2 qv qv^T`;
  * `quat_multiply(q, p) = L(q) p`.

Every function works on the last axes and batches over leading ones;
branches are `torch.where` selects with safe denominators.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _eye(n, like, batch=()):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(*batch, n, n)


def skew(v):
    """[v]_x such that [v]_x @ u = v x u. Batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_norm(q):
    """Normalize and enforce the JPL w>=0 sign convention."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_multiply(q, p):
    """JPL product q ⊗ p (rotation composition: R(q⊗p) = R(q) R(p))."""
    q, p = torch.broadcast_tensors(q, p)
    qv, qw = q[..., :3], q[..., 3:4]
    pv, pw = p[..., :3], p[..., 3:4]
    cross = torch.linalg.cross(qv, pv, dim=-1)
    vec = qw * pv + pw * qv - cross
    w = qw[..., 0] * pw[..., 0] - (qv * pv).sum(-1)
    return quat_norm(torch.cat([vec, w[..., None]], dim=-1))


def quat_inv(q):
    """Inverse (conjugate for unit quaternions): [-qv, w]."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_to_rot(q):
    """JPL quaternion -> SO(3): R = (2w^2-1) I - 2w [qv]_x + 2 qv qv^T."""
    qv, w = q[..., :3], q[..., 3]
    eye = _eye(3, q, q.shape[:-1])
    outer = qv[..., :, None] * qv[..., None, :]
    return (
        (2.0 * w**2 - 1.0)[..., None, None] * eye
        - 2.0 * w[..., None, None] * skew(qv)
        + 2.0 * outer
    )


def rot_to_quat(R):
    """SO(3) -> JPL quaternion, branchless largest-pivot selection
    (all four candidates of the reference's `rot_2_quat`, pick by the
    largest pivot)."""
    T = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    q0x = safe_sqrt((1.0 + 2.0 * r00 - T) / 4.0)
    c0 = torch.stack(
        [
            q0x,
            (R[..., 0, 1] + R[..., 1, 0]) / (4.0 * q0x),
            (R[..., 0, 2] + R[..., 2, 0]) / (4.0 * q0x),
            (R[..., 1, 2] - R[..., 2, 1]) / (4.0 * q0x),
        ],
        dim=-1,
    )
    q1y = safe_sqrt((1.0 + 2.0 * r11 - T) / 4.0)
    c1 = torch.stack(
        [
            (R[..., 0, 1] + R[..., 1, 0]) / (4.0 * q1y),
            q1y,
            (R[..., 1, 2] + R[..., 2, 1]) / (4.0 * q1y),
            (R[..., 2, 0] - R[..., 0, 2]) / (4.0 * q1y),
        ],
        dim=-1,
    )
    q2z = safe_sqrt((1.0 + 2.0 * r22 - T) / 4.0)
    c2 = torch.stack(
        [
            (R[..., 0, 2] + R[..., 2, 0]) / (4.0 * q2z),
            (R[..., 1, 2] + R[..., 2, 1]) / (4.0 * q2z),
            q2z,
            (R[..., 0, 1] - R[..., 1, 0]) / (4.0 * q2z),
        ],
        dim=-1,
    )
    q3w = safe_sqrt((1.0 + T) / 4.0)
    c3 = torch.stack(
        [
            (R[..., 1, 2] - R[..., 2, 1]) / (4.0 * q3w),
            (R[..., 2, 0] - R[..., 0, 2]) / (4.0 * q3w),
            (R[..., 0, 1] - R[..., 1, 0]) / (4.0 * q3w),
            q3w,
        ],
        dim=-1,
    )
    best = torch.stack([r00, r11, r22, T], dim=-1).argmax(dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return quat_norm(torch.gather(cands, -2, idx)[..., 0, :])


def _sinc_ratios_sq(t2):
    """(sin θ/θ, (1-cos θ)/θ², (θ - sin θ)/θ³) from θ², with the Taylor
    branch below θ² = 1e-6 (a polynomial in θ², no sqrt)."""
    small = t2 < 1e-6
    t2s = torch.where(small, t2, torch.zeros_like(t2))
    one = torch.ones_like(t2)
    safe = torch.sqrt(torch.where(small, one, t2))
    a = torch.where(small, 1.0 - t2s / 6.0 + t2s * t2s / 120.0, torch.sin(safe) / safe)
    b = torch.where(
        small,
        0.5 - t2s / 24.0 + t2s * t2s / 720.0,
        (1.0 - torch.cos(safe)) / torch.where(small, one, t2),
    )
    c = torch.where(
        small,
        1.0 / 6.0 - t2s / 120.0 + t2s * t2s / 5040.0,
        (safe - torch.sin(safe)) / torch.where(small, one, t2 * safe),
    )
    return a, b, c


def exp_so3(w):
    """SO(3) exponential map: axis-angle (...,3) -> rotation (...,3,3)."""
    a, b, _ = _sinc_ratios_sq((w * w).sum(-1))
    W = skew(w)
    return _eye(3, w, W.shape[:-2]) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R):
    """SO(3) logarithm: rotation matrix -> axis-angle vector (clamped
    acos of (tr-1)/2, vee of the skew part scaled by θ/(2 sin θ), with
    the θ ≈ π axis recovered from the diagonal)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = sin_t.abs() < 1e-7
    near_pi = small & (cos_t < 0.0)
    one = torch.ones_like(sin_t)
    scale = torch.where(small, 0.5 * one, theta / torch.where(small, one, 2.0 * sin_t))
    w_generic = scale[..., None] * vee
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, min=0.0))
    sx = torch.ones_like(axis[..., 0])
    sy = torch.sign(R[..., 0, 1] + R[..., 1, 0] + _EPS)
    sz = torch.sign(R[..., 0, 2] + R[..., 2, 0] + _EPS)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    nrm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.where(nrm < _EPS, torch.ones_like(nrm), nrm)
    w_pi = theta[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def quat_to_axis_angle(q):
    """JPL quaternion -> rotation vector of R(q)."""
    return log_so3(quat_to_rot(q))


def axis_angle_to_quat(w):
    """Rotation vector -> JPL quaternion with R(q) = exp_so3(w)."""
    return rot_to_quat(exp_so3(w))


def jl_so3(w):
    """Left Jacobian of SO(3): I + (1-cosθ)/θ² W + (θ-sinθ)/θ³ W²."""
    _, b, c = _sinc_ratios_sq((w * w).sum(-1))
    W = skew(w)
    return _eye(3, w, W.shape[:-2]) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def jr_so3(w):
    """Right Jacobian: Jr(w) = Jl(-w)."""
    return jl_so3(-w)


def jl_so3_inv(w):
    """Inverse left Jacobian (closed form with a cot guard)."""
    t2 = (w * w).sum(-1)
    small = t2 < 1e-12
    one = torch.ones_like(t2)
    safe = torch.sqrt(torch.where(small, one, t2))
    cot_term = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        1.0 / torch.where(small, one, t2) - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)),
    )
    W = skew(w)
    return _eye(3, w, W.shape[:-2]) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def omega(w):
    """Ω(ω) = [[-[ω]_x, ω], [-ω^T, 0]] for JPL q̇ = ½ Ω(ω) q."""
    top = torch.cat([-skew(w), w[..., :, None]], dim=-1)  # (...,3,4)
    bottom = torch.cat([-w, torch.zeros_like(w[..., :1])], dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def _homogeneous(R, p):
    """[[R, p], [0, 1]] from (...,3,3) and (...,3)."""
    top = torch.cat([R, p[..., :, None]], dim=-1)
    bottom = (torch.arange(4, device=R.device) == 3).to(R.dtype)
    return torch.cat([top, bottom.expand(R.shape[:-2] + (1, 4))], dim=-2)


def exp_se3(xi):
    """SE(3) exponential: twist [ω, v] (...,6) -> (...,4,4), T = [[exp(ω),
    Jl(ω) v], [0, 1]] (reference `exp_se3`)."""
    w, v = xi[..., :3], xi[..., 3:]
    return _homogeneous(exp_so3(w), (jl_so3(w) @ v[..., None])[..., 0])


def log_se3(T):
    """SE(3) logarithm: (...,4,4) -> twist [ω, v]."""
    w = log_so3(T[..., :3, :3])
    v = (jl_so3_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([w, v], dim=-1)


def hat_se3(xi):
    """se(3) hat: [ω, v] -> (...,4,4) [[ [ω]_x, v], [0, 0]]."""
    top = torch.cat([skew(xi[..., :3]), xi[..., 3:, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def inv_se3(T):
    """Inverse of a homogeneous transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def rot_to_rpy(R):
    """Rotation matrix -> roll/pitch/yaw (reference `rot2rpy`)."""
    yaw = torch.atan2(R[..., 0, 1], R[..., 0, 0])
    c = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 0, 1] ** 2)
    pitch = torch.atan2(-R[..., 0, 2], c)
    roll = torch.atan2(R[..., 1, 2], R[..., 2, 2])
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_to_rot(rpy):
    """roll/pitch/yaw -> rotation matrix, the inverse of `rot_to_rpy`."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    zero = torch.zeros_like(r)
    one = torch.ones_like(r)
    Rx = torch.stack(
        [torch.stack([one, zero, zero], -1), torch.stack([zero, cr, sr], -1),
         torch.stack([zero, -sr, cr], -1)], -2,
    )
    Ry = torch.stack(
        [torch.stack([cp, zero, -sp], -1), torch.stack([zero, one, zero], -1),
         torch.stack([sp, zero, cp], -1)], -2,
    )
    Rz = torch.stack(
        [torch.stack([cy, sy, zero], -1), torch.stack([-sy, cy, zero], -1),
         torch.stack([zero, zero, one], -1)], -2,
    )
    return Rx @ Ry @ Rz

"""Rotations, rigid motions and the radial-tangential camera, in PyTorch,
for the traffic generator: copied with the simulator from the port's
`math/quat_ops.py` and `cam/models.py`, so that the simulated sensors
are those of the port's own simulator. JPL quaternions `[qx, qy, qz, qw]`.
"""

from __future__ import annotations

import torch

_EPS = 1e-12
RADTAN = 0


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


def jl_so3(w):
    """Left Jacobian of SO(3): I + (1-cosθ)/θ² W + (θ-sinθ)/θ³ W²."""
    _, b, c = _sinc_ratios_sq((w * w).sum(-1))
    W = skew(w)
    return _eye(3, w, W.shape[:-2]) + b[..., None, None] * W + c[..., None, None] * (W @ W)


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


def _distort_radtan_norm(d, xy):
    k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distort(params, uv_norm):
    """Normalized points (...,2) -> radial-tangential pixels (...,2)."""
    return _distort_radtan_norm(params[..., 4:8], uv_norm) * params[..., 0:2] + params[..., 2:4]

"""Camera projection/distortion models on tensors.

Port of `uvio_tpu/cam/models.py`: pinhole projection with
radial-tangential ("radtan") or equidistant fisheye ("equi")
distortion. Intrinsics are a flat `(..., 8)` vector
`[fx, fy, cx, cy, d0, d1, d2, d3]` (radtan: k1 k2 p1 p2; equi: k1 k2
k3 k4). All functions batch over leading dims; the model is a static
Python int.

`distort_jacobian` is written in closed form: `uvio_tpu` takes it by
autodiff of `distort`, and the parity tests hold the two together.
"""

from __future__ import annotations

import torch

RADTAN = 0
EQUI = 1

_UNDISTORT_ITERS = 20


def _distort_radtan_norm(d, xy):
    k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _equi_terms(d, xy):
    """(r, small, theta, theta_d) of the equidistant warp."""
    k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    r = torch.sqrt(xy[..., 0] ** 2 + xy[..., 1] ** 2)
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    return r, r < 1e-12, theta, theta_d


def _distort_equi_norm(d, xy):
    r, small, _, theta_d = _equi_terms(d, xy)
    safe_r = torch.where(small, torch.ones_like(r), r)
    scale = torch.where(small, torch.ones_like(r), theta_d / safe_r)
    return xy * scale[..., None]


def distort(params, model, uv_norm):
    """Normalized coords (...,2) -> raw pixel coords (...,2)."""
    fxy, cxy, d = params[..., 0:2], params[..., 2:4], params[..., 4:8]
    if model == RADTAN:
        warped = _distort_radtan_norm(d, uv_norm)
    elif model == EQUI:
        warped = _distort_equi_norm(d, uv_norm)
    else:
        raise ValueError(f"unknown camera model {model}")
    return warped * fxy + cxy


def undistort(params, model, uv):
    """Raw pixel coords (...,2) -> normalized coords (...,2), with a
    fixed 20 iterations (`uvio_tpu` `models.py:91,102`)."""
    fxy, cxy, d = params[..., 0:2], params[..., 2:4], params[..., 4:8]
    pt = (uv - cxy) / fxy
    if model == RADTAN:
        k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
        xy = pt
        for _ in range(_UNDISTORT_ITERS):
            x, y = xy[..., 0], xy[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            xy = (pt - torch.stack([dx, dy], dim=-1)) / radial[..., None]
        return xy
    if model == EQUI:
        k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
        theta_d = torch.linalg.vector_norm(pt, dim=-1)
        theta = theta_d
        for _ in range(_UNDISTORT_ITERS):
            t2 = theta * theta
            f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
            fp = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
            theta = theta - f / fp
        small = theta_d < 1e-12
        one = torch.ones_like(theta_d)
        safe = torch.where(small, one, theta_d)
        scale = torch.where(small, one, torch.tan(theta) / safe)
        return pt * scale[..., None]
    raise ValueError(f"unknown camera model {model}")


def distort_jacobian(params, model, uv_norm):
    """(d uv / d uv_norm (...,2,2), d uv / d intrinsics (...,2,8))."""
    params = params.expand(uv_norm.shape[:-1] + (8,))
    fx, fy = params[..., 0], params[..., 1]
    d = params[..., 4:8]
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    if model == RADTAN:
        k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dradial = 2.0 * k1 + 4.0 * k2 * r2  # d radial / d r2 times 2
        dxd_dx = radial + x * x * dradial + 2.0 * p1 * y + 6.0 * p2 * x
        dxd_dy = x * y * dradial + 2.0 * p1 * x + 2.0 * p2 * y
        dyd_dx = x * y * dradial + 2.0 * p1 * x + 2.0 * p2 * y
        dyd_dy = radial + y * y * dradial + 6.0 * p1 * y + 2.0 * p2 * x
        warped = _distort_radtan_norm(d, uv_norm)
        dxd_dd = torch.stack([x * r2, x * r2 * r2, 2.0 * x * y, r2 + 2.0 * x * x], dim=-1)
        dyd_dd = torch.stack([y * r2, y * r2 * r2, r2 + 2.0 * y * y, 2.0 * x * y], dim=-1)
    elif model == EQUI:
        k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
        r, small, theta, theta_d = _equi_terms(d, uv_norm)
        safe_r = torch.where(small, one, r)
        t2 = theta * theta
        dthd_dth = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))
        dthd_dr = dthd_dth / (1.0 + safe_r * safe_r)
        scale = torch.where(small, one, theta_d / safe_r)
        # d scale / d xy = (dthd_dr r - theta_d) / r^2 * xy / r
        g = torch.where(small, zero, (dthd_dr * safe_r - theta_d) / safe_r**3)
        dxd_dx = scale + g * x * x
        dxd_dy = g * x * y
        dyd_dx = g * x * y
        dyd_dy = scale + g * y * y
        warped = uv_norm * scale[..., None]
        pw = [theta * t2, theta * t2**2, theta * t2**3, theta * t2**4]
        ds_dd = torch.stack([torch.where(small, zero, v / safe_r) for v in pw], dim=-1)
        dxd_dd = x[..., None] * ds_dd
        dyd_dd = y[..., None] * ds_dd
    else:
        raise ValueError(f"unknown camera model {model}")
    J_norm = torch.stack(
        [
            torch.stack([fx * dxd_dx, fx * dxd_dy], dim=-1),
            torch.stack([fy * dyd_dx, fy * dyd_dy], dim=-1),
        ],
        dim=-2,
    )
    J_calib = torch.stack(
        [
            torch.cat([torch.stack([warped[..., 0], zero, one, zero], -1),
                       fx[..., None] * dxd_dd], dim=-1),
            torch.cat([torch.stack([zero, warped[..., 1], zero, one], -1),
                       fy[..., None] * dyd_dd], dim=-1),
        ],
        dim=-2,
    )
    return J_norm, J_calib


def project(params, model, p_cam):
    """3D point in camera frame (...,3) -> raw pixel coords (...,2)."""
    return distort(params, model, p_cam[..., 0:2] / p_cam[..., 2:3])

"""Landmark representations, batched over landmark slots.

Port of `uvio_tpu/update/representations.py` (the reference's
`LandmarkRepresentation.h` and `UpdaterHelper::
get_feature_jacobian_representation`). The six representations:

  * GLOBAL_3D                      — the value is p_FinG;
  * ANCHORED_MSCKF_INVERSE_DEPTH   — (alpha, beta, rho) in the anchor
    camera frame (anchor = a clone slot and a camera);
  * ANCHORED_3D                    — p_FinA in the anchor camera frame;
  * GLOBAL_FULL_INVERSE_DEPTH      — spherical (theta, phi, rho), global;
  * ANCHORED_FULL_INVERSE_DEPTH    — spherical in the anchor frame;
  * ANCHORED_INVERSE_DEPTH_SINGLE  — 1-dof depth along a frozen bearing
    (stored as 3 values; only the rho column/row carries error).

Every map takes values with any leading batch shape (...,3). Where
`uvio_tpu` vmaps over slots, these functions work on the (S,...) tensors
directly. `anchor_change` re-anchors every moved landmark in one
covariance transform (see its docstring).
"""

from __future__ import annotations

import torch

from ..math import quat_to_rot, skew
from ..types.layout import StateLayout
from ..types.state import FilterState, take

GLOBAL_3D = 0
ANCHORED_MSCKF_INVERSE_DEPTH = 1
ANCHORED_3D = 2
GLOBAL_FULL_INVERSE_DEPTH = 3
ANCHORED_FULL_INVERSE_DEPTH = 4
ANCHORED_INVERSE_DEPTH_SINGLE = 5


def _safe(x, eps=1e-8):
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def _rows3(r0, r1, r2):
    return torch.stack([torch.stack(r0, -1), torch.stack(r1, -1), torch.stack(r2, -1)], -2)


def invdepth_to_point(val):
    """(alpha, beta, rho) -> p_FinA (anchor camera frame)."""
    a, b, rho = val.unbind(-1)
    s = _safe(rho)
    return torch.stack([a / s, b / s, 1.0 / s], -1)


def point_to_invdepth(p_FinA):
    z = _safe(p_FinA[..., 2])
    return torch.stack([p_FinA[..., 0] / z, p_FinA[..., 1] / z, 1.0 / z], -1)


def d_point_d_invdepth(val):
    """d p_FinA / d (alpha, beta, rho) (...,3,3)."""
    a, b, rho = val.unbind(-1)
    ir = 1.0 / _safe(rho)
    ir2 = ir * ir
    z = torch.zeros_like(ir)
    return _rows3([ir, z, -a * ir2], [z, ir, -b * ir2], [z, z, -ir2])


def d_invdepth_d_point(p_FinA):
    """d (alpha, beta, rho) / d p_FinA (...,3,3)."""
    x, y, zz = p_FinA.unbind(-1)
    zz = _safe(zz)
    z = torch.zeros_like(zz)
    return _rows3([1.0 / zz, z, -x / zz**2], [z, 1.0 / zz, -y / zz**2], [z, z, -1.0 / zz**2])


def sphere_to_point(val):
    """(theta, phi, rho) spherical inverse depth -> point."""
    th, ph, rho = val.unbind(-1)
    s = _safe(rho)
    return torch.stack(
        [torch.cos(th) * torch.sin(ph), torch.sin(th) * torch.sin(ph), torch.cos(ph)], -1
    ) / s[..., None]


def point_to_sphere(p):
    rho = 1.0 / torch.clamp(torch.linalg.vector_norm(p, dim=-1), min=1e-8)
    ph = torch.arccos(torch.clamp(rho * p[..., 2], -1.0, 1.0))
    th = torch.atan2(p[..., 1], p[..., 0])
    return torch.stack([th, ph, rho], -1)


def d_point_d_sphere(val):
    """d point / d (theta, phi, rho) (`UpdaterHelper.cpp:62-71`)."""
    th, ph, rho = val.unbind(-1)
    s = _safe(rho)
    st, ct, sp, cp = torch.sin(th), torch.cos(th), torch.sin(ph), torch.cos(ph)
    return _rows3(
        [-st * sp / s, ct * cp / s, -ct * sp / s**2],
        [ct * sp / s, st * cp / s, -st * sp / s**2],
        [torch.zeros_like(th), -sp / s, -cp / s**2],
    )


def d_sphere_d_point(p):
    """d (theta, phi, rho) / d point (...,3,3), the closed form of what
    `uvio_tpu` takes by `jacfwd(point_to_sphere)` (away from |p| <= 1e-8
    and the poles, where that clamps)."""
    x, y, z = p.unbind(-1)
    n2 = (p * p).sum(-1)
    n = torch.sqrt(n2)
    r2 = x * x + y * y
    zero = torch.zeros_like(x)
    d_th = torch.stack([-y / r2, x / r2, zero], -1)
    u = z / n
    du = (torch.stack([zero, zero, torch.ones_like(z)], -1) - (z / n2)[..., None] * p) / n[..., None]
    d_ph = -du / torch.sqrt(1.0 - u * u)[..., None]
    d_rho = -p / (n2 * n)[..., None]
    return torch.stack([d_th, d_ph, d_rho], -2)


def is_anchored(rep: int) -> bool:
    return rep in (
        ANCHORED_MSCKF_INVERSE_DEPTH,
        ANCHORED_3D,
        ANCHORED_FULL_INVERSE_DEPTH,
        ANCHORED_INVERSE_DEPTH_SINGLE,
    )


def _rho_only(like):
    """[0, 0, 1]: the one error dof of ANCHORED_INVERSE_DEPTH_SINGLE."""
    return (torch.arange(3, device=like.device) == 2).to(like.dtype)


def value_from_anchor_point(rep: int, p_FinA):
    """Anchor-frame point -> representation value."""
    if rep == ANCHORED_3D:
        return p_FinA
    if rep == ANCHORED_FULL_INVERSE_DEPTH:
        return point_to_sphere(p_FinA)
    return point_to_invdepth(p_FinA)


def anchor_point_from_value(rep: int, val):
    if rep == ANCHORED_3D:
        return val
    if rep == ANCHORED_FULL_INVERSE_DEPTH:
        return sphere_to_point(val)
    return invdepth_to_point(val)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape[:-1] + (3, 3))


def d_anchor_point_d_value(rep: int, val):
    if rep == ANCHORED_3D:
        return _eye3(val)
    if rep == ANCHORED_FULL_INVERSE_DEPTH:
        return d_point_d_sphere(val)
    J = d_point_d_invdepth(val)
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        J = J * _rho_only(val)  # bearing frozen: rho column only
    return J


def d_value_d_anchor_point(rep: int, p_FinA):
    if rep == ANCHORED_3D:
        return _eye3(p_FinA)
    if rep == ANCHORED_FULL_INVERSE_DEPTH:
        return d_sphere_d_point(p_FinA)
    J = d_invdepth_d_point(p_FinA)
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        J = J * _rho_only(p_FinA)[:, None]  # only the rho row maps back
    return J


def _anchor_cam_pose(state: FilterState, slot, cam, fej: bool):
    """(R_GtoC, p_CinG, R_GtoI, p_IinG) of clone `slot` seen by camera
    `cam`; `slot` and `cam` are index tensors that broadcast together, or
    `slot` is a Python int (read with no index upload)."""
    q_all = state.clones_q_fej if fej else state.clones_q
    p_all = state.clones_p_fej if fej else state.clones_p
    if isinstance(slot, int):
        q = q_all[slot].expand(cam.shape + (4,))
        p_I = p_all[slot].expand(cam.shape + (3,))
    else:
        slot, cam = torch.broadcast_tensors(slot, cam)
        q, p_I = take(q_all, slot), take(p_all, slot)
    R_GtoI = quat_to_rot(q)
    R_ItoC = quat_to_rot(take(state.calib_cam_q, cam))
    p_IinC = take(state.calib_cam_p, cam)
    R_GtoC = R_ItoC @ R_GtoI
    p_CinI = -(R_ItoC.transpose(-1, -2) @ p_IinC[..., None])[..., 0]
    p_CinG = p_I + (R_GtoI.transpose(-1, -2) @ p_CinI[..., None])[..., 0]
    return R_GtoC, p_CinG, R_GtoI, p_I


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def landmark_global(state: FilterState, layout: StateLayout, fej: bool = False):
    """(S,3) global positions of every landmark slot and the (S,3,3) chain
    Jacobian d p_FinG / d value (identity for GLOBAL_3D)."""
    rep = layout.slam_rep
    vals = state.slam_p_fej if fej else state.slam_p
    if rep == GLOBAL_3D:
        return vals, _eye3(vals)
    if rep == GLOBAL_FULL_INVERSE_DEPTH:
        return sphere_to_point(vals), d_point_d_sphere(vals)
    R_GtoC, p_CinG, _, _ = _anchor_cam_pose(state, state.slam_anchor_slot, state.slam_anchor_cam, fej)
    R_CtoG = R_GtoC.transpose(-1, -2)
    p_FinG = _mv(R_CtoG, anchor_point_from_value(rep, vals)) + p_CinG
    return p_FinG, R_CtoG @ d_anchor_point_d_value(rep, vals)


def anchored_chain(state: FilterState, layout: StateLayout):
    """Per-slot linearization pieces with the reference's FEJ handling
    (`UpdaterHelper.cpp:88-99`): the current best global position is
    re-expressed in the FEJ anchor frame.

    Returns (p_glob (S,3), p_glob_fej (S,3), J_rep (S,3,3) = d p_FinG /
    d value, H_anc (S,3,6) = d p_FinG / d(anchor theta, p))."""
    S = layout.max_slam
    rep = layout.slam_rep
    zeros_anc = torch.zeros((S, 3, 6), dtype=state.slam_p.dtype, device=state.slam_p.device)
    if rep == GLOBAL_3D:
        return state.slam_p, state.slam_p_fej, _eye3(state.slam_p), zeros_anc
    if rep == GLOBAL_FULL_INVERSE_DEPTH:
        # FEJ on the stored value (UpdaterHelper.cpp:45-46)
        return (sphere_to_point(state.slam_p), sphere_to_point(state.slam_p_fej),
                d_point_d_sphere(state.slam_p_fej), zeros_anc)

    slot, cam = state.slam_anchor_slot, state.slam_anchor_cam
    R_GtoC, p_CinG, _, _ = _anchor_cam_pose(state, slot, cam, False)
    p_FinG = _mv(R_GtoC.transpose(-1, -2), anchor_point_from_value(rep, state.slam_p)) + p_CinG
    # the current best, in the FEJ anchor frame
    R_GtoI_f = quat_to_rot(take(state.clones_q_fej, slot))
    p_I_f = take(state.clones_p_fej, slot)
    R_ItoC = quat_to_rot(take(state.calib_cam_q, cam))
    p_IinC = take(state.calib_cam_p, cam)
    p_FinA_fej = _mv(R_ItoC @ R_GtoI_f, p_FinG - p_I_f) + p_IinC
    R_CtoG = R_GtoI_f.transpose(-1, -2) @ R_ItoC.transpose(-1, -2)
    J_rep = R_CtoG @ d_anchor_point_d_value(rep, value_from_anchor_point(rep, p_FinA_fej))
    H_anc_th = -R_GtoI_f.transpose(-1, -2) @ skew(_mv(R_ItoC.transpose(-1, -2), p_FinA_fej - p_IinC))
    H_anc = torch.cat([H_anc_th, _eye3(p_FinG)], dim=-1)
    return p_FinG, p_FinG, J_rep, H_anc


def point_to_rep(state: FilterState, layout: StateLayout, p_FinG, anchor_slot, anchor_cam):
    """Global points (...,3) -> representation values for an anchor."""
    rep = layout.slam_rep
    if rep == GLOBAL_3D:
        return p_FinG
    if rep == GLOBAL_FULL_INVERSE_DEPTH:
        return point_to_sphere(p_FinG)
    R_GtoC, p_CinG, _, _ = _anchor_cam_pose(state, anchor_slot, anchor_cam, False)
    return value_from_anchor_point(rep, _mv(R_GtoC, p_FinG - p_CinG))


def anchor_change(state: FilterState, layout: StateLayout, marg_slot, new_slot):
    """Re-anchor every valid landmark anchored at clone `marg_slot` to
    clone `new_slot` (0-d index tensors; `marg_slot` may be a Python int,
    which indexes with no upload): the value exactly, the
    covariance to first order (`UpdaterSLAM::change_anchors`).

    `uvio_tpu` scans the slots and, per moved landmark s, replaces its
    covariance rows with Phi_s P (Phi_s reads only landmark s's own
    columns and the two clone blocks). Those rows are disjoint and no
    Phi_s reads another landmark's columns, so the scan equals one
    transform P' = T P T^T, T the identity with the rows of the moved
    landmarks replaced by their Phi_s — computed here for all slots at
    once, with the slot decision a select inside T.
    """
    rep = layout.slam_rep
    if not is_anchored(rep):
        return state
    L = layout
    S, D = L.max_slam, L.dim
    cov = state.cov
    dtype, device = cov.dtype, cov.device
    needs = state.slam_valid & (state.slam_anchor_slot == marg_slot)  # (S,)
    cam = state.slam_anchor_cam
    R_ItoC = quat_to_rot(take(state.calib_cam_q, cam))
    p_IinC = take(state.calib_cam_p, cam)
    # current estimates: exact value transform
    R_a, p_a, _, _ = _anchor_cam_pose(state, marg_slot, cam, False)
    R_n, p_n, _, _ = _anchor_cam_pose(state, new_slot, cam, False)
    p_FinG = _mv(R_a.transpose(-1, -2), anchor_point_from_value(rep, state.slam_p)) + p_a
    new_val = value_from_anchor_point(rep, _mv(R_n, p_FinG - p_n))

    # FEJ anchor poses for the transform's Jacobians (UpdaterSLAM.cpp:525-610)
    R_af, p_af, R_Iaf, _ = _anchor_cam_pose(state, marg_slot, cam, True)
    R_nf, p_nf, _, _ = _anchor_cam_pose(state, new_slot, cam, True)
    pA_lin_old = _mv(R_af, p_FinG - p_af)
    pA_lin_new = _mv(R_nf, p_FinG - p_nf)
    Jd_old = d_anchor_point_d_value(rep, value_from_anchor_point(rep, pA_lin_old))
    Jinv_new = d_value_d_anchor_point(rep, pA_lin_new)
    R_CtoI = R_ItoC.transpose(-1, -2)
    A = Jinv_new @ R_nf @ (R_af.transpose(-1, -2) @ Jd_old)
    B_th = Jinv_new @ R_nf @ (-R_Iaf.transpose(-1, -2) @ skew(_mv(R_CtoI, pA_lin_old - p_IinC)))
    B_p = Jinv_new @ R_nf
    C_th = Jinv_new @ R_ItoC @ skew(_mv(R_CtoI, pA_lin_new - p_IinC))
    C_p = -Jinv_new @ R_nf

    # Phi (S,3,D): A at each landmark's own columns, then B and C at the
    # old and new clone columns, written in that order (when the two
    # slots coincide C overwrites B, as uvio_tpu's slice updates do)
    eyeS = torch.eye(S, dtype=dtype, device=device)
    own = torch.einsum("sij,st->sitj", A, eyeS).reshape(S, 3, 3 * S)
    Phi = torch.cat([
        torch.zeros((S, 3, L.slam_off), dtype=dtype, device=device), own,
        torch.zeros((S, 3, D - L.slam_off - 3 * S), dtype=dtype, device=device),
    ], dim=-1)
    ar6 = torch.arange(6, device=device)
    Phi = Phi.index_copy(2, L.clone_off + 6 * marg_slot + ar6, torch.cat([B_th, B_p], -1))
    Phi = Phi.index_copy(2, L.clone_off + 6 * new_slot + ar6, torch.cat([C_th, C_p], -1))

    eyeD = torch.eye(D, dtype=dtype, device=device)
    lo, hi = L.slam_off, L.slam_off + 3 * S
    rows = torch.where(needs[:, None, None], Phi, eyeD[lo:hi].reshape(S, 3, D)).reshape(3 * S, D)
    T = torch.cat([eyeD[:lo], rows, eyeD[hi:]], dim=0)
    cov = T @ cov @ T.T

    # the FEJ value moves with the FEJ anchor poses (UpdaterSLAM.cpp:560-576)
    p_FinG_fej = _mv(R_af.transpose(-1, -2), anchor_point_from_value(rep, state.slam_p_fej)) + p_af
    new_fej = value_from_anchor_point(rep, _mv(R_nf, p_FinG_fej - p_nf))
    sel = needs[:, None]
    return state.replace(
        cov=cov,
        slam_p=torch.where(sel, new_val, state.slam_p),
        slam_p_fej=torch.where(sel, new_fej, state.slam_p_fej),
        slam_anchor_slot=torch.where(needs, new_slot, state.slam_anchor_slot),
    )

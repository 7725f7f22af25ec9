"""MSCKF visual update, batched over a padded feature set.

Port of `uvio_tpu/update/msckf.py` (the reference's
`ov_msckf/src/update/UpdaterMSCKF.{h,cpp}` + `UpdaterHelper`):

  * per-feature measurement Jacobians with FEJ linearization points,
    GLOBAL_3D representation, optional camera calibration columns;
  * nullspace projection of H_f by batched complete QR over packed
    (valid-rows-first) per-feature systems;
  * 95% chi2 gating;
  * measurement compression by one tall reduced QR, then one EKF update.

Shapes: F features x K clone slots x C cameras, 2 rows per observation.
Masked rows are exact zeros throughout, which leaves them inert. QR
bases may differ from LAPACK build to LAPACK build by signs and
rotations; every quantity used downstream (chi2 statistic, compressed
normal equations) is invariant to that.

`msckf_update` runs everything after the stacked systems (`_systems`:
triangulation and `feature_system`) as one launch of a hand-written CUDA
kernel (`csrc/msckf_update.cu`) on CUDA tensors, and as
`msckf_update_ref`, the plain version above, on CPU tensors. The kernel
works on the camera calibration and clone columns alone, where a
feature's H_x lies, and compresses to that many rows; it changes the
covariance and the mean blocks of `filter.ekf`'s `inject_table`. Under
`torch.func.vmap` (the batched steps) the launch's batch rule runs one
cluster of blocks a sequence, so a batch is one launch too.
"""

from __future__ import annotations

import torch

from .. import launches
from ..cam import models as cam_models
from ..filter.ekf import MASKS, cho_solve, cholesky_or_nan, ekf_update, inject_table, table_ints
from ..math import quat_to_rot, skew
from ..math.chi2 import _device_table, chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState
from .triangulation import triangulate_batch


def clone_camera_poses(state: FilterState, layout: StateLayout):
    """Per (clone slot, camera) world->camera poses: ((R_GtoC (K,C,3,3),
    p_CinG (K,C,3)) at the current values, the same at FEJ points)."""
    R_ItoC = quat_to_rot(state.calib_cam_q)  # (C,3,3)
    p_CinI = -(R_ItoC.transpose(-1, -2) @ state.calib_cam_p[..., None])[..., 0]  # (C,3)

    def cam_pose(q, p):
        R_GtoI = quat_to_rot(q)  # (K,3,3)
        R_GtoC = R_ItoC[None] @ R_GtoI[:, None]  # (K,C,3,3)
        p_CinG = p[:, None] + (R_GtoI.transpose(-1, -2)[:, None] @ p_CinI[None, :, :, None])[..., 0]
        return R_GtoC, p_CinG

    return cam_pose(state.clones_q, state.clones_p), cam_pose(state.clones_q_fej, state.clones_p_fej)


def feature_system(state, layout, cam_model, feat_p, feat_p_fej, obs_uv, obs_mask, sigma_pix):
    """Stacked measurement system for a feature batch.

    feat_p/feat_p_fej (F,3); obs_uv (F,K,C,2) raw pixels; obs_mask
    (F,K,C). Returns H_x (F,M,D), H_f (F,M,3), res (F,M), row_mask (F,M)
    with M = 2*K*C.
    """
    L = layout
    K, C, D = L.max_clones, L.num_cams, L.dim
    F = feat_p.shape[0]
    dtype, device = state.cov.dtype, state.cov.device

    R_GtoI = quat_to_rot(state.clones_q)
    R_GtoI_fej = quat_to_rot(state.clones_q_fej)
    R_ItoC = quat_to_rot(state.calib_cam_q)
    p_IinC = state.calib_cam_p
    intr = state.calib_cam_intr

    # value leg: predicted measurements at the current estimates
    dpf = feat_p[:, None, :] - state.clones_p[None, :, :]  # (F,K,3)
    p_FinI = torch.einsum("kij,fkj->fki", R_GtoI, dpf)
    p_FinC = torch.einsum("cij,fkj->fkci", R_ItoC, p_FinI) + p_IinC[None, None]
    z = p_FinC[..., 2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    uvn = p_FinC[..., 0:2] / safe_z[..., None]  # (F,K,C,2)
    uv_pred = torch.stack(
        [cam_models.distort(intr[c], cam_model, uvn[:, :, c, :]) for c in range(C)], dim=2
    )
    res2 = obs_uv - uv_pred

    # Jacobian leg: FEJ geometry, projection Jacobian at the FEJ point,
    # distortion Jacobian at the current uv (`UpdaterHelper.cpp:354-372`)
    dpf_fej = feat_p_fej[:, None, :] - state.clones_p_fej[None, :, :]
    p_FinI_fej = torch.einsum("kij,fkj->fki", R_GtoI_fej, dpf_fej)
    p_FinC_fej = torch.einsum("cij,fkj->fkci", R_ItoC, p_FinI_fej) + p_IinC[None, None]
    z_fej = p_FinC_fej[..., 2]
    safe_zf = torch.where(z_fej.abs() < 1e-6, torch.full_like(z_fej, 1e-6), z_fej)

    jac = [cam_models.distort_jacobian(intr[c], cam_model, uvn[:, :, c, :]) for c in range(C)]
    J_norm = torch.stack([j[0] for j in jac], dim=2)  # (F,K,C,2,2)
    J_calib = torch.stack([j[1] for j in jac], dim=2)  # (F,K,C,2,8)
    zero = torch.zeros_like(safe_zf)
    one = torch.ones_like(safe_zf)
    Hproj = torch.stack(
        [
            torch.stack([one / safe_zf, zero, -p_FinC_fej[..., 0] / safe_zf**2], dim=-1),
            torch.stack([zero, one / safe_zf, -p_FinC_fej[..., 1] / safe_zf**2], dim=-1),
        ],
        dim=-2,
    )  # (F,K,C,2,3)
    Hcam = J_norm @ Hproj  # d uv / d p_FinC

    dpc_dth = R_ItoC[None, None] @ skew(p_FinI_fej)[:, :, None]  # (F,K,C,3,3)
    RR_fej = R_ItoC[None] @ R_GtoI_fej[:, None]  # (K,C,3,3)
    H_th = Hcam @ dpc_dth
    H_p = Hcam @ (-RR_fej)[None]
    H_f = Hcam @ RR_fej[None]

    lead = (F, K, C, 2)
    blocks = [torch.zeros(lead + (L.calib_off,), dtype=dtype, device=device)]
    eyeC = torch.eye(C, dtype=dtype, device=device)
    if L.calib_cam_timeoffset:
        blocks.append(torch.zeros(lead + (1,), dtype=dtype, device=device))
    if L.calib_cam_pose:
        sk_c = skew(p_FinC_fej - p_IinC[None, None])
        H_ext = torch.cat([Hcam @ sk_c, Hcam], dim=-1)  # (F,K,C,2,6)
        blocks.append(torch.einsum("fkcre,cd->fkcrde", H_ext, eyeC).reshape(lead + (6 * C,)))
    if L.calib_cam_intrinsics:
        blocks.append(torch.einsum("fkcre,cd->fkcrde", J_calib, eyeC).reshape(lead + (8 * C,)))
    if L.calib_uwb_extrinsics:
        blocks.append(torch.zeros(lead + (3,), dtype=dtype, device=device))
    H_clone = torch.cat([H_th, H_p], dim=-1)  # (F,K,C,2,6)
    eyeK = torch.eye(K, dtype=dtype, device=device)
    blocks.append(torch.einsum("fkcre,kj->fkcrje", H_clone, eyeK).reshape(lead + (6 * K,)))
    tail = L.dim - L.slam_off
    if tail > 0:
        blocks.append(torch.zeros(lead + (tail,), dtype=dtype, device=device))
    Hx = torch.cat(blocks, dim=-1)

    M = K * C * 2
    row_mask = obs_mask[..., None].expand(obs_mask.shape + (2,))
    rm = row_mask.to(dtype)
    Hx = (Hx * rm[..., None]).reshape(F, M, D)
    H_f = (H_f * rm[..., None]).reshape(F, M, 3)
    res = (res2 * rm).reshape(F, M)
    return Hx, H_f, res, row_mask.reshape(F, M)


def _pack_rows(Hx, H_f, res, row_mask):
    """Reorder each feature's rows so valid rows come first (stable):
    with trailing all-zero rows, Householder QR of H_f leaves those rows
    untouched and the nullspace projection is exact for padded systems."""
    order = torch.argsort((~row_mask).to(torch.int32), dim=1, stable=True)
    take = lambda a: torch.gather(a, 1, order[..., None].expand(-1, -1, a.shape[-1]))
    return take(Hx), take(H_f), torch.gather(res, 1, order), torch.gather(row_mask, 1, order)


def nullspace_project(Hx, H_f, res):
    """Left-nullspace projection of H_f per feature via batched complete
    QR. Returns (Hx_proj (F,M-3,D), res_proj (F,M-3))."""
    Q, _ = torch.linalg.qr(H_f, mode="complete")  # (F,M,M)
    Q2t = Q[..., 3:].transpose(-1, -2)
    return Q2t @ Hx, (Q2t @ res[..., None])[..., 0]


def chi2_gate(Hx_proj, res_proj, cov, nobs_rows, sigma_pix, chi2_mult=1.0):
    """Per-feature Mahalanobis gating (UpdaterMSCKF.cpp:221-243).
    nobs_rows (F,) = number of valid rows (2n); dof = 2n - 3.
    Returns (keep (F,), chi2 statistic (F,))."""
    eye = torch.eye(Hx_proj.shape[1], dtype=Hx_proj.dtype, device=Hx_proj.device)
    S = Hx_proj @ cov @ Hx_proj.transpose(-1, -2) + sigma_pix**2 * eye
    sol = cho_solve(cholesky_or_nan(S), res_proj[..., None])[..., 0]
    gamma = (res_proj * sol).sum(-1)
    dof = torch.clamp(nobs_rows - 3, min=1)
    return gamma < chi2_mult * chi2_95(dof, max_dof=Hx_proj.shape[1]), gamma


def compress_and_update(state, layout, Hx_proj, res_proj, keep, sigma_pix):
    """Stack kept features, compress via tall QR, one EKF update."""
    F, Mp, D = Hx_proj.shape
    w = keep.to(Hx_proj.dtype)
    H_big = (Hx_proj * w[:, None, None]).reshape(F * Mp, D)
    r_big = (res_proj * w[:, None]).reshape(F * Mp)
    Q, Rf = torch.linalg.qr(H_big, mode="reduced")  # (rows,D),(D,D)
    r_c = Q.T @ r_big
    r_diag = torch.full((D,), sigma_pix**2, dtype=H_big.dtype, device=H_big.device)
    mask = torch.ones((D,), dtype=torch.bool, device=H_big.device)
    return ekf_update(state, layout, Rf, r_c, r_diag, mask)


def _systems(state, layout, cam_model, obs_uv, obs_mask, sigma_pix):
    """Triangulation and the stacked systems of a padded feature batch:
    (H_x (F,M,D), H_f (F,M,3), res (F,M), row_mask (F,M), tri_ok (F,))."""
    L = layout
    K, C = L.max_clones, L.num_cams
    obs_uv = obs_uv.to(state.cov.dtype)
    uvn_obs = torch.stack(
        [cam_models.undistort(state.calib_cam_intr[c], cam_model, obs_uv[:, :, c, :]) for c in range(C)],
        dim=2,
    )
    (R_val, p_val), _ = clone_camera_poses(state, layout)
    feat_p, tri_ok = triangulate_batch(
        uvn_obs.reshape(-1, K * C, 2), obs_mask.reshape(-1, K * C),
        R_val.reshape(K * C, 3, 3), p_val.reshape(K * C, 3),
    )
    Hx, H_f, res, row_mask = feature_system(
        state, layout, cam_model, feat_p, feat_p, obs_uv, obs_mask, sigma_pix
    )
    return Hx, H_f, res, row_mask, tri_ok


def msckf_update_ref(state, layout, cam_model, obs_uv, obs_mask, sigma_pix=1.0, chi2_mult=1.0):
    """The plain version of `msckf_update`: batched complete QR
    projection, gate, one tall reduced QR and a D-row `ekf_update`."""
    Hx, H_f, res, row_mask, tri_ok = _systems(state, layout, cam_model, obs_uv, obs_mask, sigma_pix)
    # drop features that failed triangulation or have <2 observations
    ok = tri_ok & (row_mask.sum(1) >= 4)
    okf = ok.to(Hx.dtype)
    Hx = Hx * okf[:, None, None]
    H_f = H_f * okf[:, None, None]
    res = res * okf[:, None]
    row_mask = row_mask & ok[:, None]

    Hx_p, H_f_p, res_p, rm_p = _pack_rows(Hx, H_f, res, row_mask)
    Hx_proj, res_proj = nullspace_project(Hx_p, H_f_p, res_p)
    keep, chi2 = chi2_gate(Hx_proj, res_proj, state.cov, rm_p.sum(1), sigma_pix, chi2_mult)
    keep = keep & ok
    new_state, diag = compress_and_update(state, layout, Hx_proj, res_proj, keep, sigma_pix)
    info = {"tri_ok": tri_ok, "kept": keep, "num_used": keep.sum(), "cov_ok": diag["cov_ok"], "chi2": chi2}
    return new_state, info


def msckf_update(state, layout, cam_model, obs_uv, obs_mask, sigma_pix=1.0, chi2_mult=1.0):
    """Full MSCKF update on a padded feature batch (UpdaterMSCKF::update).

    obs_uv (F,K,C,2) raw pixel tracks aligned to clone slots; obs_mask
    (F,K,C). Triangulates, builds Jacobians, projects, gates, compresses
    and applies one EKF update. Returns (new_state, info dict). CUDA
    tensors take the kernel from the stacked systems on, CPU tensors
    `msckf_update_ref` (module docstring).
    """
    if not launches.route(state.cov, obs_uv, obs_mask):
        return msckf_update_ref(state, layout, cam_model, obs_uv, obs_mask, sigma_pix, chi2_mult)
    L = layout
    Hx, H_f, res, row_mask, tri_ok = _systems(state, L, cam_model, obs_uv, obs_mask, sigma_pix)
    table = inject_table(L)
    cov, *fields, kept, chi2, num_used, cov_ok = launches.Launch.apply(
        _launch, state.cov, Hx, H_f, res, row_mask, tri_ok, _device_table(state.cov.device),
        [getattr(state, m) for m in MASKS], [getattr(state, b.field) for b in table],
        kernel_ints(L, obs_uv.shape[-4]), (float(sigma_pix) ** 2, float(chi2_mult)))
    new = state.replace(cov=cov, **{b.field: f for b, f in zip(table, fields)})
    return new, {"tri_ok": tri_ok, "kept": kept, "num_used": num_used, "cov_ok": cov_ok, "chi2": chi2}


# ---------------------------------------------------------------------------
# The kernel's arguments
# ---------------------------------------------------------------------------

def kernel_ints(layout: StateLayout, F: int) -> list:
    """The layout's part of the kernel's int arguments (`uvio_msckf_update`
    in `csrc/msckf_update.cu`, from `dim` on): dim, F, M (a feature's
    rows, 2 K C), calib_off and W = slam_off - calib_off (the camera
    calibration and clone columns, `feature_system`'s support, which sizes
    the kernel's shared memory), then the table (`filter.ekf.table_ints`).
    The kernel refuses a table or shape it does not take."""
    L = layout
    return [L.dim, F, 2 * L.max_clones * L.num_cams, L.calib_off, L.slam_off - L.calib_off,
            *table_ints(inject_table(L))]


def _launch(batch, cov, hx, hf, res, row_mask, tri_ok, quantiles, masks, fields, ints, reals):
    """One launch for `batch` sequences held back to back in each tensor:
    (cov, *fields, kept, chi2, num_used, cov_ok), freshly allocated."""
    from .. import _build

    launches.check_table("msckf_update", batch, cov, masks, fields, ints[5:])
    dtype, device = cov.dtype, cov.device
    D, F, M, W = ints[0], ints[1], ints[2], ints[4]
    launches.check("msckf_update", device, ("cov", cov, dtype, batch * D * D),
                   ("H_x", hx, dtype, batch * F * M * D), ("H_f", hf, dtype, batch * F * M * 3),
                   ("res", res, dtype, batch * F * M), ("row_mask", row_mask, torch.bool, batch * F * M),
                   ("tri_ok", tri_ok, torch.bool, batch * F),
                   ("chi2 quantiles", quantiles, torch.float64, quantiles.numel()))
    cov_out = torch.empty_like(cov)
    kept = torch.empty_like(tri_ok)
    chi2 = torch.empty((batch * F,), dtype=dtype, device=device).reshape(tri_ok.shape)
    num_used = torch.empty(tri_ok.shape[:-1], dtype=torch.int64, device=device)
    cov_ok = torch.empty(tri_ok.shape[:-1], dtype=torch.bool, device=device)
    # a sequence's workspace, as the library lays it out
    per_seq = _build.load().uvio_msckf_work_bytes(int(dtype == torch.float64), D, F, M, W)
    work = torch.empty((batch * per_seq,), dtype=torch.uint8, device=device)
    ptrs = [cov, cov_out, hx, hf, res, row_mask, tri_ok, quantiles, *masks, kept, chi2, num_used, cov_ok, work]
    outs = launches.launch("msckf_update", batch, ptrs, fields, ints, reals)
    return (cov_out, *outs, kept, chi2, num_used, cov_ok)

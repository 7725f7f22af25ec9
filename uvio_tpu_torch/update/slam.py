"""SLAM landmark updates: delayed initialization and re-observation.

Port of `uvio_tpu/update/slam.py` (the reference's
`ov_msckf/src/update/UpdaterSLAM.{h,cpp}`):

  * `slam_update` (UpdaterSLAM::update): EKF update of the landmarks in
    the state from their new observations; each landmark's Jacobian lands
    in its own covariance columns (no nullspace projection); per-landmark
    chi2 failures are reported for the host's fail counter.
  * `slam_delayed_init` (UpdaterSLAM::delayed_init): triangulate candidate
    tracks, split each stacked system by QR into an invertible 3-dof init
    system and an update system (`StateHelper::initialize`), chi2-gate,
    write the landmark into its slot, then apply the update rows.

Observation tensors are indexed by slam slot (S,K,C,·), so landmark
columns sit at static offsets. Candidates initialize one after another
(each changes the covariance). `slam_delayed_init` runs that chain as one
launch of a hand-written CUDA kernel (`csrc/slam_init.cu`) on CUDA
tensors, and as `slam_delayed_init_ref`, the plain version, on CPU
tensors: a Python loop over the static candidate count, each candidate's
outcome a select, so nothing waits for the host. Both share the batched
part before the loop (`_candidate_systems`: triangulation, Jacobians,
packed rows). The kernel changes the covariance, the mean blocks of
`filter.ekf`'s `inject_table` and the landmark fields of the slots it
fills; under `torch.func.vmap` (the batched full step) the launch's batch
rule runs one cluster of blocks a sequence, so a batch is one launch too.
"""

from __future__ import annotations

import torch

from .. import launches
from ..cam import models as cam_models
from ..filter.ekf import (
    MASKS,
    _slot_index,
    cho_solve,
    cholesky_or_nan,
    ekf_update,
    initialize_invertible_block,
    inject_table,
    table_ints,
)
from ..math import quat_to_rot, skew
from ..math.chi2 import chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState, take, where_state
from .msckf import _pack_rows, clone_camera_poses, feature_system
from .representations import (
    ANCHORED_INVERSE_DEPTH_SINGLE,
    ANCHORED_MSCKF_INVERSE_DEPTH,
    GLOBAL_3D,
    GLOBAL_FULL_INVERSE_DEPTH,
    anchor_point_from_value,
    anchored_chain,
    d_anchor_point_d_value,
    d_point_d_sphere,
    is_anchored,
    point_to_rep,
    value_from_anchor_point,
)
from .triangulation import triangulate_batch


def _gamma(H, r, cov, sigma_pix):
    """Batched chi2 statistic r^T (H P H^T + s^2 I)^-1 r; NaN (which every
    gate rejects) where the Cholesky factor fails, as in `uvio_tpu`."""
    eye = torch.eye(H.shape[-2], dtype=H.dtype, device=H.device)
    Sm = H @ cov @ H.transpose(-1, -2) + sigma_pix**2 * eye
    sol = cho_solve(cholesky_or_nan(Sm), r[..., None])[..., 0]
    return (r * sol).sum(-1)


def slam_update(state, layout, obs_uv, obs_mask, cam_model, sigma_pix=1.0, chi2_mult=1.0):
    """EKF update on the landmarks in the state. obs tensors (S,K,C,·) are
    aligned to slam slots; invalid slots are masked out here."""
    L = layout
    S, K, C, D = L.max_slam, L.max_clones, L.num_cams, L.dim
    dtype = state.cov.dtype
    obs_uv = obs_uv.to(dtype)
    obs_mask = obs_mask & state.slam_valid[:, None, None]

    p_glob, p_glob_fej, J_rep, H_anc = anchored_chain(state, L)
    Hx, H_fG, res, row_mask = feature_system(
        state, L, cam_model, p_glob, p_glob_fej, obs_uv, obs_mask, sigma_pix
    )
    M = Hx.shape[1]
    # each landmark's block in its own slot columns (one-hot outer product)
    H_f = H_fG @ J_rep  # (S,M,3)
    eyeS = torch.eye(S, dtype=dtype, device=Hx.device)
    slam_block = torch.einsum("smj,st->smtj", H_f, eyeS).reshape(S, M, 3 * S)
    lo, hi = L.slam_off, L.slam_off + 3 * S
    Hx = torch.cat([Hx[..., :lo], slam_block, Hx[..., hi:]], dim=-1)
    # anchor-pose columns (UpdaterHelper.cpp:100-112), added into the
    # anchor clone's columns
    if L.slam_rep != GLOBAL_3D:
        extra = H_fG @ H_anc  # (S,M,6)
        onehot = (torch.arange(K, device=Hx.device) == state.slam_anchor_slot[:, None]).to(dtype)
        add = torch.einsum("sme,sk->smke", extra, onehot).reshape(S, M, 6 * K)
        c0, c1 = L.clone_off, L.clone_off + 6 * K
        Hx = torch.cat([Hx[..., :c0], Hx[..., c0:c1] + add, Hx[..., c1:]], dim=-1)

    # valid rows first, truncated to a static capacity of 8*C rows per
    # landmark (a 4-frame backlog); overflow is dropped (`slam.py:95-110`)
    Mr = min(M, 8 * C)
    order = torch.argsort((~row_mask).to(torch.int32), dim=1, stable=True)[:, :Mr]
    Hx = torch.gather(Hx, 1, order[..., None].expand(-1, -1, D))
    res = torch.gather(res, 1, order)
    row_mask_t = torch.gather(row_mask, 1, order)

    # chi2 gate per landmark, dof = rows
    gamma = _gamma(Hx, res, state.cov, sigma_pix)
    nrows = row_mask_t.sum(1)
    has_obs = nrows > 0
    keep = (gamma < chi2_mult * chi2_95(torch.clamp(nrows, min=1), max_dof=Mr)) & has_obs

    w = keep.to(dtype)
    H_big = (Hx * w[:, None, None]).reshape(S * Mr, D)
    r_big = (res * w[:, None]).reshape(S * Mr)
    # S*Mr may be below D: the compressed system has min(S*Mr, D) rows
    rows_c = min(S * Mr, D)
    Q, Rf = torch.linalg.qr(H_big, mode="reduced")
    new_state, diag = ekf_update(
        state, L, Rf, Q.T @ r_big,
        torch.full((rows_c,), sigma_pix**2, dtype=dtype, device=H_big.device),
        torch.ones((rows_c,), dtype=torch.bool, device=H_big.device),
    )
    return new_state, {"kept": keep, "failed": has_obs & ~keep, "cov_ok": diag["cov_ok"], "chi2": gamma}


def _candidate_systems(state, layout, obs_uv, obs_mask, cand_ids, cam_model, sigma_pix):
    """The delayed init's batched part: each candidate triangulated, its
    stacked system in its representation, rows packed valid-first.
    Returns (Hx_p (Fc,M,D), H_f_p (Fc,M,3), res_p (Fc,M), rm_p (Fc,M),
    active (Fc,), vals0 (Fc,3), anchor_slot, anchor_cam)."""
    L = layout
    Fc, K, C, D = obs_uv.shape[0], L.max_clones, L.num_cams, L.dim
    dtype, device = state.cov.dtype, state.cov.device
    obs_uv = obs_uv.to(dtype)
    rep = L.slam_rep

    uvn_obs = torch.stack(
        [cam_models.undistort(state.calib_cam_intr[c], cam_model, obs_uv[:, :, c, :]) for c in range(C)],
        dim=2,
    )
    (R_val, p_val), _ = clone_camera_poses(state, L)
    # GLOBAL_3D landmarks keep a frozen FEJ and need stronger geometry
    max_bl = 40.0 if rep != GLOBAL_3D else 10.0
    feat_p, tri_ok = triangulate_batch(
        uvn_obs.reshape(Fc, K * C, 2), obs_mask.reshape(Fc, K * C),
        R_val.reshape(K * C, 3, 3), p_val.reshape(K * C, 3), max_baseline=max_bl,
    )
    Hx, H_f, res, row_mask = feature_system(state, L, cam_model, feat_p, feat_p, obs_uv, obs_mask, sigma_pix)

    anchor_slot = state.clone_head
    anchor_cam = torch.zeros_like(anchor_slot)
    # the 1-dof depth rep initializes through the full inverse-depth
    # chain; its bearing dofs are frozen right after insertion
    rep_init = ANCHORED_MSCKF_INVERSE_DEPTH if rep == ANCHORED_INVERSE_DEPTH_SINGLE else rep
    if is_anchored(rep):
        vals0 = point_to_rep(state, L, feat_p, anchor_slot, anchor_cam)
        # Jacobian chain at the FEJ anchor pose (UpdaterHelper.cpp:88-99)
        R_ItoC = quat_to_rot(state.calib_cam_q[0])
        p_IinC = state.calib_cam_p[0]
        R_GtoI_af = quat_to_rot(take(state.clones_q_fej, anchor_slot))
        p_I_af = take(state.clones_p_fej, anchor_slot)
        R_GtoC_af = R_ItoC @ R_GtoI_af
        p_FinA_fej = (feat_p - p_I_af) @ R_GtoC_af.T + p_IinC  # (Fc,3)
        J_chain = R_GtoC_af.T @ d_anchor_point_d_value(rep_init, value_from_anchor_point(rep_init, p_FinA_fej))
        H_fG = H_f
        H_f = H_fG @ J_chain
        # anchor-pose term, added into the anchor clone's columns
        th = -R_GtoI_af.T @ skew((p_FinA_fej - p_IinC) @ R_ItoC)  # (Fc,3,3)
        H_anc0 = torch.cat([th, torch.eye(3, dtype=dtype, device=device).expand(Fc, 3, 3)], dim=-1)
        Hx = Hx.index_add(2, _slot_index(L.clone_off + 6 * anchor_slot, 6, device), H_fG @ H_anc0)
        # anchored features must lie in front of the anchor camera
        tri_ok = tri_ok & (anchor_point_from_value(rep, vals0)[:, 2] > 0.1)
    elif rep == GLOBAL_FULL_INVERSE_DEPTH:
        vals0 = point_to_rep(state, L, feat_p, anchor_slot, anchor_cam)
        H_f = H_f @ d_point_d_sphere(vals0)
    else:
        vals0 = feat_p
    Hx_p, H_f_p, res_p, rm_p = _pack_rows(Hx, H_f, res, row_mask)
    active = (cand_ids >= 0) & tri_ok & (rm_p.sum(1) >= 6)
    return Hx_p, H_f_p, res_p, rm_p, active, vals0, anchor_slot, anchor_cam


def slam_delayed_init_ref(state, layout, obs_uv, obs_mask, target_slots, cand_ids, cam_model, sigma_pix=1.0,
                          chi2_mult=1.0):
    """The plain version of `slam_delayed_init`: a complete QR split
    batched over the candidates, then a loop over them, each a general
    `ekf_update` and a select of every state field."""
    L = layout
    Fc = obs_uv.shape[0]
    dtype, device = state.cov.dtype, state.cov.device
    rep = L.slam_rep
    Hx_p, H_f_p, res_p, rm_p, active, vals0, anchor_slot, anchor_cam = _candidate_systems(
        state, L, obs_uv, obs_mask, cand_ids, cam_model, sigma_pix)
    M = Hx_p.shape[1]

    # QR split, batched over candidates: each rotation depends only on
    # the candidate's own H_f
    Q, _ = torch.linalg.qr(H_f_p, mode="complete")  # (Fc,M,M)
    Qt = Q.transpose(-1, -2)
    Hf_tri_b = (Qt @ H_f_p)[:, :3]
    Hx_q_b = Qt @ Hx_p
    r_q_b = (Qt @ res_p[..., None])[..., 0]
    nrows_b = torch.clamp(rm_p.sum(1), min=1)
    r3 = torch.full((3,), sigma_pix**2, dtype=dtype, device=device)
    r_up_diag = torch.full((M - 3,), sigma_pix**2, dtype=dtype, device=device)
    all_rows = torch.ones((M - 3,), dtype=torch.bool, device=device)
    ar_S = torch.arange(L.max_slam, device=device)

    st, inited, chi2 = state, [], []
    for i in range(Fc):
        Hf_tri, Hx_init, r_init = Hf_tri_b[i], Hx_q_b[i, :3], r_q_b[i, :3]
        Hx_up, r_up = Hx_q_b[i, 3:], r_q_b[i, 3:]
        slot, fid, p_f = target_slots[i], cand_ids[i], vals0[i]
        # chi2 on the update rows, dof = all rows (the reference's quirk,
        # StateHelper.cpp:469-474 uses res.rows())
        gamma = _gamma(Hx_up, r_up, st.cov, sigma_pix)
        ok = active[i] & (gamma < chi2_mult * chi2_95(nrows_b[i], max_dof=M))
        # invertibility guard (Hf_tri is triangular from the QR)
        ok = ok & (torch.diagonal(Hf_tri).prod().abs() > 1e-9)

        off = L.slam_off + 3 * slot
        new_cov, dxf = initialize_invertible_block(st.cov, off, Hx_init, Hf_tri, r3, r_init)
        # the FEJ value is the pre-correction triangulated value
        # (UpdaterSLAM.cpp:218-226 + StateHelper.cpp:393-482)
        at = ar_S == slot
        new = st.replace(
            cov=new_cov,
            slam_p=torch.where(at[:, None], p_f + dxf, st.slam_p),
            slam_p_fej=torch.where(at[:, None], p_f, st.slam_p_fej),
            slam_valid=st.slam_valid | at,
            slam_id=torch.where(at, fid, st.slam_id),
            slam_anchor_slot=torch.where(at, anchor_slot, st.slam_anchor_slot),
            slam_anchor_cam=torch.where(at, anchor_cam, st.slam_anchor_cam),
        )
        new, _ = ekf_update(new, L, Hx_up, r_up, r_up_diag, all_rows)
        if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
            # freeze the bearing: alpha/beta become known constants
            idx = _slot_index(off, 2, device)
            new = new.replace(cov=new.cov.index_fill(0, idx, 0.0).index_fill(1, idx, 0.0))
        st = where_state(ok, new, st)
        inited.append(ok)
        chi2.append(gamma)
    return st, {"inited": torch.stack(inited), "chi2": torch.stack(chi2)}


def slam_delayed_init(
    state: FilterState,
    layout: StateLayout,
    obs_uv: torch.Tensor,
    obs_mask: torch.Tensor,
    target_slots: torch.Tensor,
    cand_ids: torch.Tensor,
    cam_model: int,
    sigma_pix: float = 1.0,
    chi2_mult: float = 1.0,
):
    """Initialize up to Fc candidate landmarks into free slam slots.

    obs_uv (Fc,K,C,2), obs_mask (Fc,K,C), target_slots (Fc,) slam slots
    (free, valid indices), cand_ids (Fc,) feature ids, -1 = inactive.
    New landmarks are anchored at the newest clone (`clone_head`, a valid
    slot after propagate+clone) of camera 0. Returns (state, {inited (Fc,),
    chi2 (Fc,)}). CUDA tensors take the kernel, CPU tensors
    `slam_delayed_init_ref` (module docstring).
    """
    if not launches.route(state.cov, obs_uv, obs_mask, target_slots, cand_ids):
        return slam_delayed_init_ref(state, layout, obs_uv, obs_mask, target_slots, cand_ids, cam_model,
                                     sigma_pix, chi2_mult)
    L = layout
    Hx_p, H_f_p, res_p, rm_p, active, vals0, anchor_slot, _ = _candidate_systems(
        state, L, obs_uv, obs_mask, cand_ids, cam_model, sigma_pix)
    M = Hx_p.shape[1]
    thresh = chi2_mult * chi2_95(torch.clamp(rm_p.sum(1), min=1), max_dof=M)
    table = inject_table(L)
    cov, slam_valid, fej, *meta_fields, inited, chi2 = launches.Launch.apply(
        _launch, state.cov, Hx_p, H_f_p, res_p, thresh, active, target_slots.to(torch.int64), cand_ids.to(torch.int64),
        vals0, anchor_slot, [getattr(state, m) for m in MASKS], state.slam_p_fej,
        [getattr(state, f) for f in META], [getattr(state, b.field) for b in table],
        kernel_ints(L, Fc=obs_uv.shape[0]), (float(sigma_pix) ** 2,))
    meta, fields = meta_fields[:len(META)], meta_fields[len(META):]
    new = state.replace(cov=cov, slam_valid=slam_valid, slam_p_fej=fej, **dict(zip(META, meta)),
                        **{b.field: f for b, f in zip(table, fields)})
    return new, {"inited": inited, "chi2": chi2}


# ---------------------------------------------------------------------------
# The kernel's arguments
# ---------------------------------------------------------------------------


# the landmark fields the kernel writes at an accepted candidate's slot
# besides its mean, its FEJ value and its mask
META = ("slam_id", "slam_anchor_slot", "slam_anchor_cam")


def cluster_size(Fc: int) -> int:
    """The blocks of a sequence's cluster: one a candidate, at most the
    portable cluster size of 8."""
    return min(Fc, 8)


def kernel_ints(layout: StateLayout, Fc: int) -> list:
    """The layout's part of the kernel's int arguments (`uvio_slam_init`
    in `csrc/slam_init.cu`, from `dim` on): dim, Fc, M (a candidate's
    rows, 2 K C), the most columns a candidate's H_x touches (the camera
    calibration and clone columns, `feature_system`'s support), slam_off,
    max_slam, whether the bearing freezes (the single-depth
    representation), the cluster size, the table row of slam_p, then the
    table (`filter.ekf.table_ints`). The kernel refuses a table or shape
    it does not take."""
    L = layout
    if L.max_slam < 1:
        raise ValueError("the SLAM init kernel needs 1 or more landmark slots")
    table = inject_table(L)
    row = {b.field: i for i, b in enumerate(table)}
    return [L.dim, Fc, 2 * L.max_clones * L.num_cams, L.slam_off - L.calib_off, L.slam_off, L.max_slam,
            int(L.slam_rep == ANCHORED_INVERSE_DEPTH_SINGLE),
            cluster_size(Fc), row["slam_p"], *table_ints(table)]


def work_bytes(D: int, Fc: int, M: int, itemsize: int) -> int:
    """Bytes of a sequence's workspace (`work_layout` in
    `csrc/slam_init.cu`): the transformed rows and residuals, R, gamma,
    the Gram matrices, the cross terms, P H^T and K of the update and dx
    in values, then each candidate's live columns and gate in ints; a
    multiple of 16."""
    values = Fc * M * D + Fc * M + 10 * Fc + Fc * M * M + 3 * D + 2 * M * D + D
    b = values * itemsize + Fc * (D + 2) * 4
    return (b + 15) // 16 * 16


def _launch(batch, cov, hx, hf, res, thresh, active, slots, ids, vals0, anchor, masks, fej, meta, fields, ints,
            reals):
    """One launch for `batch` sequences held back to back in each tensor:
    (cov, slam_valid, slam_p_fej, *meta, *fields, inited, chi2), freshly
    allocated."""
    launches.check_table("slam_delayed_init", batch, cov, masks, fields, ints[9:])
    if len(meta) != len(META):
        raise ValueError(f"slam_delayed_init: {len(meta)} landmark fields for {len(META)}")
    dtype, device = cov.dtype, cov.device
    D, Fc, M, S = ints[0], ints[1], ints[2], ints[5]
    launches.check("slam_delayed_init", device, ("cov", cov, dtype, batch * D * D),
                   ("H_x", hx, dtype, batch * Fc * M * D), ("H_f", hf, dtype, batch * Fc * M * 3),
                   ("res", res, dtype, batch * Fc * M), ("thresh", thresh, torch.float64, batch * Fc),
                   ("active", active, torch.bool, batch * Fc), ("target_slots", slots, torch.int64, batch * Fc),
                   ("cand_ids", ids, torch.int64, batch * Fc), ("vals0", vals0, dtype, batch * Fc * 3),
                   ("clone_head", anchor, torch.int64, batch), ("slam_valid", masks[1], torch.bool, batch * S),
                   ("slam_p_fej", fej, dtype, batch * S * 3),
                   *[(n, t, torch.int64, batch * S) for n, t in zip(META, meta)])
    cov_out = torch.empty_like(cov)
    valid_out = torch.empty_like(masks[1])
    fej_out = torch.empty_like(fej)
    meta_out = [torch.empty_like(t) for t in meta]
    inited = torch.empty_like(active)
    chi2 = torch.empty((batch * Fc,), dtype=dtype, device=device).reshape(active.shape)
    per_seq = work_bytes(D, Fc, M, cov.element_size())
    work = torch.empty((batch * per_seq,), dtype=torch.uint8, device=device)
    ptrs = [cov, cov_out, hx, hf, res, thresh, active, slots, ids, vals0, anchor, *masks, valid_out, fej, fej_out,
            *meta, *meta_out, inited, chi2, work]
    outs = launches.launch("slam_init", batch, ptrs, fields, [per_seq, *ints], reals)
    return (cov_out, valid_out, fej_out, *meta_out, *outs, inited, chi2)

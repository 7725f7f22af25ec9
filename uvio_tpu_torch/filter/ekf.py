"""EKF kernels on the fixed-layout state.

Port of `uvio_tpu/filter/ekf.py` (the reference's
`ov_msckf/src/state/StateHelper.{h,cpp}`):

  * `propagate_covariance`  <-  EKFPropagation on the leading IMU block
  * `ekf_update`            <-  EKFUpdate with masked padded rows
  * `augment_clone`         <-  stochastic cloning into a ring slot
  * `marginalize_clone/slam`<-  slot invalidation + row/col zeroing
  * `initialize_invertible_block` <- initialize_invertible (the new
    block's rows written at its slot instead of a matrix resize)

Functions are pure: they return new tensors and never write into their
inputs. Slot offsets are device tensors, and writes at them are
`index_copy` on a copy, so nothing waits for the host.
"""

from __future__ import annotations

import torch

from ..math import quat_multiply, quat_norm
from ..types.layout import IMU_MODEL_KALIBR, StateLayout
from ..types.state import FilterState


def propagate_covariance(cov: torch.Tensor, phi: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """P <- [Phi 0; 0 I] P [.]^T + diag(Qd, 0) for the leading block.

    `phi` is (15, b): the top rows of the block transition over
    [imu(15) | imu-intrinsics(b-15)]; only the 15 IMU rows change.
    """
    b = phi.shape[1]
    rows = phi @ cov[:b, :]  # (15, D)
    new_ii = rows[:, :b] @ phi.T + qd
    cov = cov.clone()
    cov[:15, :] = rows
    cov[:, :15] = rows.T
    cov[:15, :15] = 0.5 * (new_ii + new_ii.T)
    return cov


def _dq(dtheta):
    """Small JPL error quaternion [dtheta/2, 1], normalized."""
    w = torch.ones(dtheta.shape[:-1] + (1,), dtype=dtheta.dtype, device=dtheta.device)
    return quat_norm(torch.cat([0.5 * dtheta, w], dim=-1))


def inject(state: FilterState, layout: StateLayout, dx: torch.Tensor) -> FilterState:
    """Apply an error-state correction to every mean block (masked).
    FEJ linearization points are left untouched."""
    L = layout
    q = quat_multiply(_dq(dx[L.theta_off : L.theta_off + 3]), state.q)
    p = state.p + dx[L.p_off : L.p_off + 3]
    v = state.v + dx[L.v_off : L.v_off + 3]
    bg = state.bg + dx[L.bg_off : L.bg_off + 3]
    ba = state.ba + dx[L.ba_off : L.ba_off + 3]
    dxc = dx[L.clone_off : L.clone_off + 6 * L.max_clones].reshape(L.max_clones, 6)
    cmask = state.clones_valid[:, None]
    clones_q = torch.where(cmask, quat_multiply(_dq(dxc[:, 0:3]), state.clones_q), state.clones_q)
    clones_p = torch.where(cmask, state.clones_p + dxc[:, 3:6], state.clones_p)
    changes = dict(q=q, p=p, v=v, bg=bg, ba=ba, clones_q=clones_q, clones_p=clones_p)
    if L.max_slam > 0:
        dxs = dx[L.slam_off : L.slam_off + 3 * L.max_slam].reshape(L.max_slam, 3)
        changes["slam_p"] = torch.where(state.slam_valid[:, None], state.slam_p + dxs, state.slam_p)
    if L.calib_imu_intrinsics:
        changes["calib_imu_dw"] = state.calib_imu_dw + dx[L.imu_dw_off : L.imu_dw_off + 6]
        changes["calib_imu_da"] = state.calib_imu_da + dx[L.imu_da_off : L.imu_da_off + 6]
        if L.calib_imu_g_sensitivity:
            changes["calib_imu_tg"] = state.calib_imu_tg + dx[L.imu_tg_off : L.imu_tg_off + 9]
        dq_imu = _dq(dx[L.imu_theta_off : L.imu_theta_off + 3])
        if L.imu_model == IMU_MODEL_KALIBR:
            changes["calib_imu_gq"] = quat_multiply(dq_imu, state.calib_imu_gq)
        else:
            changes["calib_imu_aq"] = quat_multiply(dq_imu, state.calib_imu_aq)
    if L.calib_cam_timeoffset:
        changes["calib_dt"] = state.calib_dt + dx[L.calib_dt_off]
    if L.calib_cam_pose:
        dxe = dx[L.calib_cam_pose_off : L.calib_cam_pose_off + 6 * L.num_cams].reshape(L.num_cams, 6)
        changes["calib_cam_q"] = quat_multiply(_dq(dxe[:, 0:3]), state.calib_cam_q)
        changes["calib_cam_p"] = state.calib_cam_p + dxe[:, 3:6]
    if L.calib_cam_intrinsics:
        dxi = dx[L.calib_cam_intr_off : L.calib_cam_intr_off + 8 * L.num_cams].reshape(L.num_cams, 8)
        changes["calib_cam_intr"] = state.calib_cam_intr + dxi
    if L.calib_uwb_extrinsics:
        changes["uwb_p_IinU"] = state.uwb_p_IinU + dx[L.calib_uwb_off : L.calib_uwb_off + 3]
    if L.max_anchors > 0:
        dxa = dx[L.anchor_off : L.anchor_off + 5 * L.max_anchors].reshape(L.max_anchors, 5)
        amask = state.anchors_valid
        changes["anchors_p"] = torch.where(amask[:, None], state.anchors_p + dxa[:, 0:3], state.anchors_p)
        changes["anchors_gamma"] = torch.where(amask, state.anchors_gamma + dxa[:, 3], state.anchors_gamma)
        changes["anchors_alpha"] = torch.where(amask, state.anchors_alpha + dxa[:, 4], state.anchors_alpha)
    return state.replace(**changes)


def cholesky_or_nan(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorization fails, as JAX's
    `cho_factor` returns (`cholesky_ex` reports failure without a host
    check)."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def ekf_update(
    state: FilterState,
    layout: StateLayout,
    H: torch.Tensor,
    res: torch.Tensor,
    r_diag: torch.Tensor,
    mask: torch.Tensor,
):
    """Masked dense EKF update; returns (new_state, diagnostics).

    `H` (m, D), `res` (m,), `r_diag` (m,) noise variances, `mask` (m,)
    bool for real rows (`StateHelper::EKFUpdate`, `ekf.py:182-220`).
    """
    m = H * mask[:, None]
    r = res * mask
    rd = torch.where(mask, r_diag, torch.ones_like(r_diag))
    PHt = state.cov @ m.T  # (D, m)
    S = m @ PHt + torch.diag(rd)
    S = 0.5 * (S + S.T)
    K = torch.cholesky_solve(PHt.T, cholesky_or_nan(S)).T  # (D, m)
    dx = K @ r
    cov = state.cov - K @ PHt.T
    cov = 0.5 * (cov + cov.T)
    new_state = inject(state.replace(cov=cov), layout, dx)
    # corrupted-covariance flag with a dtype/scale-aware tolerance
    diag = torch.diagonal(cov)
    eps = torch.finfo(cov.dtype).eps
    tol = torch.clamp(32.0 * eps * torch.clamp(diag.max(), min=1.0), min=1e-9)
    return new_state, {"dx": dx, "cov_ok": (diag > -tol).all()}


def _slot_index(off, size: int, device) -> torch.Tensor:
    """Indices off..off+size-1; `off` is an int or a device tensor."""
    return off + torch.arange(size, device=device)


def _zero_rows_cols(cov: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return cov.index_fill(0, idx, 0.0).index_fill(1, idx, 0.0)


def augment_clone(state: FilterState, layout: StateLayout, w_hat: torch.Tensor) -> FilterState:
    """Stochastically clone the current IMU pose into the next ring slot
    (`StateHelper::augment_clone`)."""
    L = layout
    K = L.max_clones
    head = state.clone_head
    slot = torch.where(head < 0, torch.zeros_like(head), torch.remainder(head + 1, K))
    cov = state.cov
    idx = _slot_index(L.clone_off + 6 * slot, 6, cov.device)

    J = torch.zeros((6, L.dim), dtype=cov.dtype, device=cov.device)
    eye3 = torch.eye(3, dtype=cov.dtype, device=cov.device)
    J[0:3, L.theta_off : L.theta_off + 3] = eye3
    J[3:6, L.p_off : L.p_off + 3] = eye3
    if L.calib_cam_timeoffset:
        J[0:3, L.calib_dt_off] = w_hat
        J[3:6, L.calib_dt_off] = state.v

    rows = J @ cov  # (6, D)
    block = rows @ J.T  # (6, 6)
    cov = cov.index_copy(0, idx, rows)
    cov = cov.index_copy(1, idx, rows.T)
    cov[idx[:, None], idx[None, :]] = block

    onehot = torch.arange(K, device=slot.device) == slot
    sel = onehot[:, None]
    return state.replace(
        cov=cov,
        clones_q=torch.where(sel, state.q, state.clones_q),
        clones_p=torch.where(sel, state.p, state.clones_p),
        clones_q_fej=torch.where(sel, state.q, state.clones_q_fej),
        clones_p_fej=torch.where(sel, state.p, state.clones_p_fej),
        clones_t=torch.where(onehot, state.time, state.clones_t),
        clones_valid=state.clones_valid | onehot,
        clone_head=slot,
    )


def marginalize_clone(state: FilterState, layout: StateLayout, slot) -> FilterState:
    """Drop a clone: invalidate the slot (an int or a device tensor) and
    zero its covariance rows and columns (`StateHelper::marginalize` under
    the slot-pool design)."""
    cov = _zero_rows_cols(state.cov, _slot_index(layout.clone_off + 6 * slot, 6, state.cov.device))
    onehot = torch.arange(layout.max_clones, device=state.clones_valid.device) == slot
    return state.replace(
        cov=cov,
        clones_valid=state.clones_valid & ~onehot,
        clones_t=torch.where(onehot, torch.full_like(state.clones_t, -1.0), state.clones_t),
    )


def marginalize_slam(state: FilterState, layout: StateLayout, slot) -> FilterState:
    """Drop a landmark: invalidate its slot (an int or a device tensor)
    and zero its covariance rows and columns."""
    cov = _zero_rows_cols(state.cov, _slot_index(layout.slam_off + 3 * slot, 3, state.cov.device))
    onehot = torch.arange(layout.max_slam, device=state.slam_valid.device) == slot
    return state.replace(
        cov=cov,
        slam_valid=state.slam_valid & ~onehot,
        slam_id=torch.where(onehot, torch.full_like(state.slam_id, -1), state.slam_id),
    )


def initialize_invertible_block(cov, slot_off, H_R, H_L, r_diag, res):
    """Initialize an s-dof block at offset `slot_off` (an int or a device
    tensor) from an invertible system (`StateHelper::initialize_invertible`,
    `uvio_tpu/filter/ekf.py:312-340`).

    H_R (s, D) Jacobian wrt the existing states, H_L (s, s) invertible
    Jacobian wrt the new block. Returns (new_cov, dx_new) with
    dx_new = H_L^-1 res. H_L is inverted as `uvio_tpu` does it, by QR and
    a triangular solve: unlike `torch.linalg.solve`/`inv`, neither checks
    its factor on the host, so the step keeps running without a sync.
    """
    s = H_L.shape[0]
    M_a = cov @ H_R.T  # (D, s)
    M = H_R @ M_a + torch.diag(r_diag)
    Ql, Rl = torch.linalg.qr(H_L)
    H_Linv = torch.linalg.solve_triangular(Rl, Ql.T, upper=True)
    P_LL = H_Linv @ M @ H_Linv.T
    cross = -M_a @ H_Linv.T  # (D, s)
    idx = _slot_index(slot_off, s, cov.device)
    cov = cov.index_copy(0, idx, cross.T).index_copy(1, idx, cross)
    cov[idx[:, None], idx[None, :]] = P_LL
    return cov, H_Linv @ res


def set_block_covariance(cov: torch.Tensor, slot_off, block) -> torch.Tensor:
    """Overwrite a diagonal block and zero its cross terms
    (`StateHelper::set_initial_covariance`); `block` may be numpy."""
    block = torch.as_tensor(block, dtype=cov.dtype, device=cov.device)
    idx = _slot_index(slot_off, block.shape[0], cov.device)
    cov = _zero_rows_cols(cov, idx)
    cov[idx[:, None], idx[None, :]] = block
    return cov


def get_marginal_covariance(cov: torch.Tensor, blocks) -> torch.Tensor:
    """Joint covariance of a static list of (offset, size) error-state
    blocks, rows and columns in block order
    (`StateHelper::get_marginal_covariance`)."""
    idx = torch.cat([torch.arange(off, off + size, device=cov.device) for off, size in blocks])
    return cov[idx[:, None], idx[None, :]]

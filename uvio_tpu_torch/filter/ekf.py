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

from typing import NamedTuple, Optional

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


class Block(NamedTuple):
    """A mean block that an update changes: state field `field` holds
    `rows` rows of `width` values; row r's error is `err_stride` values
    from `err_off + r * err_stride` (3 for a quaternion row, else
    `width`); `mask` names the bool field of the rows to change (None:
    every row)."""

    field: str
    quat: bool
    rows: int
    width: int
    err_off: int
    err_stride: int
    mask: Optional[str] = None


# the valid masks a block may name
MASKS = ("clones_valid", "slam_valid", "anchors_valid")


def inject_table(layout: StateLayout) -> tuple:
    """The mean blocks of `layout` as `Block`s, in the order `inject`
    changes them: what an error-state correction is injected into."""
    L = layout
    K, S, A, C = L.max_clones, L.max_slam, L.max_anchors, L.num_cams
    t = [Block("q", True, 1, 4, L.theta_off, 3), Block("p", False, 1, 3, L.p_off, 3),
         Block("v", False, 1, 3, L.v_off, 3), Block("bg", False, 1, 3, L.bg_off, 3),
         Block("ba", False, 1, 3, L.ba_off, 3),
         Block("clones_q", True, K, 4, L.clone_off, 6, "clones_valid"),
         Block("clones_p", False, K, 3, L.clone_off + 3, 6, "clones_valid")]
    if S > 0:
        t.append(Block("slam_p", False, S, 3, L.slam_off, 3, "slam_valid"))
    if L.calib_imu_intrinsics:
        t += [Block("calib_imu_dw", False, 1, 6, L.imu_dw_off, 6),
              Block("calib_imu_da", False, 1, 6, L.imu_da_off, 6)]
        if L.calib_imu_g_sensitivity:
            t.append(Block("calib_imu_tg", False, 1, 9, L.imu_tg_off, 9))
        rot = "calib_imu_gq" if L.imu_model == IMU_MODEL_KALIBR else "calib_imu_aq"
        t.append(Block(rot, True, 1, 4, L.imu_theta_off, 3))
    if L.calib_cam_timeoffset:
        t.append(Block("calib_dt", False, 1, 1, L.calib_dt_off, 1))
    if L.calib_cam_pose:
        t += [Block("calib_cam_q", True, C, 4, L.calib_cam_pose_off, 6),
              Block("calib_cam_p", False, C, 3, L.calib_cam_pose_off + 3, 6)]
    if L.calib_cam_intrinsics:
        t.append(Block("calib_cam_intr", False, C, 8, L.calib_cam_intr_off, 8))
    if L.calib_uwb_extrinsics:
        t.append(Block("uwb_p_IinU", False, 1, 3, L.calib_uwb_off, 3))
    if A > 0:
        t += [Block("anchors_p", False, A, 3, L.anchor_off, 5, "anchors_valid"),
              Block("anchors_gamma", False, A, 1, L.anchor_off + 3, 5, "anchors_valid"),
              Block("anchors_alpha", False, A, 1, L.anchor_off + 4, 5, "anchors_valid")]
    return tuple(t)


def table_ints(table) -> list:
    """`table` as the filter kernels read it (`csrc/mean_table.cuh`
    `parse_table`): the number of blocks, then each block's quat, rows,
    width, err_off, err_stride and mask (an index into `MASKS`, -1 for
    none). The kernels refuse a table they do not take."""
    return [len(table), *[v for b in table for v in (int(b.quat), b.rows, b.width, b.err_off, b.err_stride,
                                                     MASKS.index(b.mask) if b.mask else -1)]]


def inject(state: FilterState, layout: StateLayout, dx: torch.Tensor) -> FilterState:
    """Apply an error-state correction to every mean block of
    `inject_table` (quaternions by the error quaternion's product, the
    rest added; masked rows left). FEJ linearization points are left
    untouched."""
    changes = {}
    for b in inject_table(layout):
        x = getattr(state, b.field)
        n = 3 if b.quat else b.width
        if b.rows > 1 or x.dim() == 2:  # (rows, n), a view
            e = dx[b.err_off : b.err_off + (b.rows - 1) * b.err_stride + n].unfold(0, n, b.err_stride)
        else:
            e = dx[b.err_off : b.err_off + n]
        new = quat_multiply(_dq(e), x) if b.quat else x + e.reshape(x.shape)
        if b.mask is not None:
            keep = getattr(state, b.mask)
            new = torch.where(keep[:, None] if x.dim() == 2 else keep, new, x)
        changes[b.field] = new
    return state.replace(**changes)


def cholesky_or_nan(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorization fails, as JAX's
    `cho_factor` returns (`cholesky_ex` reports failure without a host
    check)."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with (L L^T) x = b for lower Cholesky factors L (batched), as two
    triangular solves (cuBLAS `trsm` on the card; JAX's `cho_solve` is
    the same pair). On the card `torch.cholesky_solve` of a batch takes
    MAGMA's `potrs_batched`, which allocates device memory from the host
    and so cannot be captured in a CUDA graph. A NaN factor gives NaN."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


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
    K = cho_solve(cholesky_or_nan(S), PHt.T).T  # (D, m)
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

    J = cov.new_zeros((6, L.dim))
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

"""UWB range updates with bias-compensated anchors.

Port of `uvio_tpu/update/uwb.py` (the reference's
`uvio/src/update/UpdaterUWB.{h,cpp}`, `UVioUpdaterHelper.cpp:147-241`).
Range model (uvio_sensor_data.h:34-69):

    y = (1 + alpha_a) d + gamma_a + n,   d = || p_AinG - p_UinG ||,
    p_UinG = p_IinG - R_GtoI^T p_IinU              (lever arm)

Each anchor's range is its own single-row update, in anchor order, so
chi2 can reject ranges one by one; each re-linearizes at the pose the
previous one corrected. The anchor index is a Python int (the loop over
anchors is static), and each accept decision is a select.
"""

from __future__ import annotations

import torch

from ..filter.ekf import ekf_update
from ..math import quat_to_rot, skew
from ..math.chi2 import chi2_95
from ..types.layout import StateLayout
from ..types.state import FilterState, where_state


def predicted_range(state: FilterState, anchor_idx: int):
    """(y_hat, d, u, p_U) for anchor slot `anchor_idx`."""
    R = quat_to_rot(state.q)
    p_U = state.p - R.T @ state.uwb_p_IinU
    diff = state.anchors_p[anchor_idx] - p_U
    d = torch.linalg.vector_norm(diff)
    u = diff / torch.where(d < 1e-9, torch.ones_like(d), d)
    y_hat = (1.0 + state.anchors_alpha[anchor_idx]) * d + state.anchors_gamma[anchor_idx]
    return y_hat, d, u, p_U


def _range_jacobian(state: FilterState, layout: StateLayout, anchor_idx: int):
    """H (1,D) of the range of one anchor, at the current pose (no FEJ,
    as the reference, `UVioUpdaterHelper.cpp:188-231`).

    Deliberate deviation from the reference, kept from `uvio_tpu`: the
    reference's anchor-position Jacobian carries a spurious R_GtoI^T
    (`UVioUpdaterHelper.cpp:238`); p_AinG is global, so d||p_A - p_U||/dp_A
    is the bare unit vector, and this uses (1+alpha) u^T.
    """
    L = layout
    _, d, u, _ = predicted_range(state, anchor_idx)
    R = quat_to_rot(state.q)
    k = 1.0 + state.anchors_alpha[anchor_idx]
    H = torch.zeros((1, L.dim), dtype=state.cov.dtype, device=state.cov.device)
    # dp_U/dtheta = R^T [p_IinU]_x (JPL left error), dy/dp_U = -(1+a) u^T
    H[0, L.theta_off : L.theta_off + 3] = -k * (u @ (R.T @ skew(state.uwb_p_IinU)))
    H[0, L.p_off : L.p_off + 3] = -k * u
    if L.calib_uwb_extrinsics:
        # dp_U/dp_IinU = -R^T
        H[0, L.calib_uwb_off : L.calib_uwb_off + 3] = k * (u @ R.T)
    # anchor block [p_A(3), gamma, alpha]: dy = [(1+a) u^T, 1, d]
    a0 = L.anchor_off + 5 * anchor_idx
    H[0, a0 : a0 + 5] = torch.cat([k * u, torch.ones_like(d)[None], d[None]])
    return H, d


def uwb_update(state, layout, ranges, range_mask, sigma_range=0.1, chi2_mult=1.0):
    """Sequential single-range updates (UpdaterUWB::update_single).

    ranges (A,), range_mask (A,). Returns (state, {accepted (A,), chi2
    (A,)})."""
    L = layout
    dtype, device = state.cov.dtype, state.cov.device
    ranges = ranges.to(dtype)
    r_diag = torch.full((1,), sigma_range**2, dtype=dtype, device=device)
    one_row = torch.ones((1,), dtype=torch.bool, device=device)
    dof1 = torch.ones((), dtype=torch.int64, device=device)
    st, accepted, chi2 = state, [], []
    for a in range(L.max_anchors):
        valid = range_mask[a] & st.anchors_valid[a]
        H, _ = _range_jacobian(st, L, a)
        y_hat = predicted_range(st, a)[0]
        r = torch.where(valid, ranges[a] - y_hat, torch.zeros_like(y_hat))[None]
        Hm = H * valid
        S = (Hm @ st.cov @ Hm.T)[0, 0] + sigma_range**2
        gamma = r[0] * r[0] / S
        accept = valid & (gamma < chi2_mult * chi2_95(dof1))
        new, _ = ekf_update(st, L, Hm, r, r_diag, one_row)
        st = where_state(accept, new, st)
        accepted.append(accept)
        chi2.append(gamma)
    return st, {"accepted": torch.stack(accepted), "chi2": torch.stack(chi2)}

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

`uwb_update` runs a range set as one launch of a hand-written CUDA kernel
(`csrc/uwb_update.cu`) on CUDA tensors and as `uwb_update_ref`, the plain
version (a general one-row `ekf_update` a slot), on CPU tensors. The
kernel changes the covariance and the mean blocks of `filter.ekf`'s
`inject_table`, the list `inject` runs over: the table, with the layout's
offsets (`kernel_ints`), is what it is given in place of the layout.
Under `torch.func.vmap` (the batched full step) the launch's batch rule
(`launches.Launch`) runs one block a sequence, so a batch is one launch
too.
"""

from __future__ import annotations

import ctypes

import torch

from .. import launches
from ..filter.ekf import MASKS, ekf_update, inject_table, table_ints
from ..math import quat_to_rot, skew
from ..math.chi2 import CHI2_95, chi2_95
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
    H = state.cov.new_zeros((1, L.dim))
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


def uwb_update_ref(state, layout, ranges, range_mask, sigma_range=0.1, chi2_mult=1.0):
    """The plain version of `uwb_update`: per slot a one-row `ekf_update`
    and a select of every state field."""
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


def uwb_update(state, layout, ranges, range_mask, sigma_range=0.1, chi2_mult=1.0):
    """Sequential single-range updates (UpdaterUWB::update_single).

    ranges (A,), range_mask (A,) bool. Returns (state, {accepted (A,),
    chi2 (A,)}). CUDA tensors take the kernel, CPU tensors
    `uwb_update_ref` (module docstring)."""
    if not launches.route(state.cov, ranges, range_mask):
        return uwb_update_ref(state, layout, ranges, range_mask, sigma_range, chi2_mult)
    table = inject_table(layout)
    cov, *fields, accepted, chi2 = launches.Launch.apply(
        _launch, state.cov, state.uwb_p_IinU, ranges.to(state.cov.dtype), range_mask,
        [getattr(state, m) for m in MASKS], [getattr(state, b.field) for b in table], kernel_ints(layout),
        (float(sigma_range) ** 2, float(chi2_mult * CHI2_95[1])))
    new = state.replace(cov=cov, **{b.field: f for b, f in zip(table, fields)})
    return new, {"accepted": accepted, "chi2": chi2}


# ---------------------------------------------------------------------------
# The kernel's arguments
# ---------------------------------------------------------------------------


def kernel_ints(layout: StateLayout) -> list:
    """The layout's part of the kernel's int arguments (`uvio_uwb_update`
    in `csrc/uwb_update.cu`, from `dim` on): dim, anchors, the error
    offsets of theta, p, the lever arm (-1 when it is not in the error
    state) and the anchors, the table rows of q, p, the lever arm (-1: it
    is read from its input), anchors_p, anchors_gamma and anchors_alpha,
    then the table (`filter.ekf.table_ints`)."""
    L = layout
    if L.max_anchors < 1:
        raise ValueError("the UWB kernel takes 1 or more anchors")
    table = inject_table(L)
    row = {b.field: i for i, b in enumerate(table)}
    lever_off = L.calib_uwb_off if L.calib_uwb_extrinsics else -1
    return [L.dim, L.max_anchors, L.theta_off, L.p_off, lever_off, L.anchor_off,
            row["q"], row["p"], row.get("uwb_p_IinU", -1), row["anchors_p"], row["anchors_gamma"],
            row["anchors_alpha"], *table_ints(table)]


def uses_shared_memory(layout: StateLayout, dtype: torch.dtype) -> bool:
    """Whether the kernel stages the layout's covariance of `dtype` in
    shared memory, or updates it in global memory (the library decides,
    by the shape, at each launch)."""
    from .. import _build

    args = [int(dtype == torch.float64), 1, *kernel_ints(layout)]
    staged = ctypes.c_int(-1)
    rc = _build.load().uvio_uwb_shared_memory((ctypes.c_int * len(args))(*args), ctypes.pointer(staged))
    if rc != 0:
        raise RuntimeError(f"uvio_uwb_shared_memory failed: cudaError {rc}")
    return bool(staged.value)


def _launch(batch, cov, lever, ranges, range_mask, masks, fields, ints, reals):
    """One launch for `batch` sequences held back to back in each tensor:
    (cov, *fields, accepted, chi2), freshly allocated."""
    launches.check_table("uwb_update", batch, cov, masks, fields, ints[12:])
    dtype, device, D, A = cov.dtype, cov.device, ints[0], ints[1]
    launches.check("uwb_update", device, ("cov", cov, dtype, batch * D * D), ("lever arm", lever, dtype, batch * 3),
                   ("ranges", ranges, dtype, batch * A), ("range_mask", range_mask, torch.bool, batch * A),
                   ("anchors_valid", masks[2], torch.bool, batch * A))
    cov_out, accepted, chi2 = torch.empty_like(cov), torch.empty_like(range_mask), torch.empty_like(ranges)
    outs = launches.launch("uwb_update", batch, [cov, cov_out, lever, *masks, ranges, range_mask, accepted, chi2],
                           fields, ints, reals)
    return (cov_out, *outs, accepted, chi2)

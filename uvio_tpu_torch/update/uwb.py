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
offsets (`kernel_ints`), is what it is given in place of the layout. Under `torch.func.vmap` (the batched full step) the
launch's batch rule (`_Kernel.vmap`) runs one block a sequence, so a batch
is one launch too.
"""

from __future__ import annotations

import ctypes

import torch

from .. import launches
from ..filter.ekf import MASKS, ekf_update, inject_table
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
    cov, *fields, accepted, chi2 = _Kernel.apply(
        state.cov, state.uwb_p_IinU, ranges.to(state.cov.dtype), range_mask,
        [getattr(state, m) for m in MASKS], [getattr(state, b.field) for b in table], kernel_ints(layout),
        float(sigma_range) ** 2, float(chi2_mult * CHI2_95[1]))
    new = state.replace(cov=cov, **{b.field: f for b, f in zip(table, fields)})
    return new, {"accepted": accepted, "chi2": chi2}


# ---------------------------------------------------------------------------
# The kernel's arguments
# ---------------------------------------------------------------------------


# the kernel's table holds at most this many blocks
MAX_BLOCKS = 24


def kernel_ints(layout: StateLayout) -> list:
    """The layout's part of the kernel's int arguments (`uvio_uwb_update`
    in `csrc/uwb_update.cu`, from `dim` on): dim, anchors, the error
    offsets of theta, p, the lever arm (-1 when it is not in the error
    state) and the anchors, the table rows of q, p, the lever arm (-1: it
    is read from its input), anchors_p, anchors_gamma and anchors_alpha,
    the number of blocks, then each block's quat, rows, width, err_off,
    err_stride and mask (an index into `MASKS`, -1 for none)."""
    L = layout
    table = inject_table(L)
    if L.max_anchors < 1 or len(table) > MAX_BLOCKS:
        raise ValueError(f"the UWB kernel takes 1 or more anchors and at most {MAX_BLOCKS} mean blocks")
    row = {b.field: i for i, b in enumerate(table)}
    lever_off = L.calib_uwb_off if L.calib_uwb_extrinsics else -1
    return [L.dim, L.max_anchors, L.theta_off, L.p_off, lever_off, L.anchor_off,
            row["q"], row["p"], row.get("uwb_p_IinU", -1), row["anchors_p"], row["anchors_gamma"],
            row["anchors_alpha"], len(table),
            *[v for b in table for v in (int(b.quat), b.rows, b.width, b.err_off, b.err_stride,
                                         MASKS.index(b.mask) if b.mask else -1)]]


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


def _check(name, t, dtype, numel, device):
    if t.dtype != dtype:
        raise TypeError(f"uwb_update {name}: expected {dtype}, got {t.dtype}")
    if t.numel() != numel:
        raise ValueError(f"uwb_update {name}: expected {numel} values, got shape {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"uwb_update {name}: must be contiguous on {device}")


def _launch(batch, cov, lever, ranges, range_mask, masks, fields, ints, sigma2, thresh):
    """One launch for `batch` sequences held back to back in each tensor:
    (cov, *fields, accepted, chi2), freshly allocated."""
    from .. import _build

    dtype, device = cov.dtype, cov.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"uwb_update: a float32 or float64 covariance, got {dtype}")
    D, A, nblocks = ints[0], ints[1], ints[12]
    if len(fields) != nblocks or len(masks) != len(MASKS):
        raise ValueError(f"uwb_update: {len(fields)} mean blocks and {len(masks)} masks for a table "
                         f"of {nblocks} and {len(MASKS)}")
    _check("cov", cov, dtype, batch * D * D, device)
    _check("lever arm", lever, dtype, batch * 3, device)
    _check("ranges", ranges, dtype, batch * A, device)
    _check("range_mask", range_mask, torch.bool, batch * A, device)
    _check("anchors_valid", masks[2], torch.bool, batch * A, device)
    for k, f in enumerate(fields):
        _, rows, width, _, _, mask = ints[13 + 6 * k: 19 + 6 * k]
        _check(f"block {k}", f, dtype, batch * rows * width, device)
        if mask >= 0:
            _check(MASKS[mask], masks[mask], torch.bool, batch * rows, device)
    cov_out = torch.empty_like(cov)
    outs = [torch.empty_like(f) for f in fields]
    accepted = torch.empty_like(range_mask)
    chi2 = torch.empty_like(ranges)
    ptrs = [cov, cov_out, lever, *masks, ranges, range_mask, accepted, chi2,
            *[t for pair in zip(fields, outs) for t in pair]]
    args = [int(dtype == torch.float64), batch, *ints]
    rc = _build.load().uvio_uwb_update(
        (ctypes.c_int64 * len(ptrs))(*[t.data_ptr() for t in ptrs]), (ctypes.c_int * len(args))(*args),
        float(sigma2), float(thresh), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"uvio_uwb_update launch failed: cudaError {rc}")
    launches.launch_counts["uwb_update"] += 1
    return (cov_out, *outs, accepted, chi2)


class _Kernel(torch.autograd.Function):
    """The launch as an autograd function, for its `vmap` rule: under
    `torch.func.vmap` every input gets its batch axis first (broadcast
    where it has none) and one launch runs `info.batch_size` blocks. (A
    `torch.library` custom operator would do the same, but registering one
    imports torch's compiler stack, ~14 s on the card's installation.)"""

    @staticmethod
    def forward(*args):
        return _launch(1, *args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        B = info.batch_size

        def front(x, d):
            if isinstance(x, list):
                return [front(y, e) for y, e in zip(x, d)]
            return (x.movedim(d, 0) if d is not None else x.expand(B, *x.shape)).contiguous()

        out = _launch(B, *[front(x, d) for x, d in zip(args[:6], in_dims[:6])], *args[6:])
        return out, (0,) * len(out)

"""Batched feature triangulation + Gauss-Newton refinement.

Port of `uvio_tpu/update/triangulation.py` (the reference's
`ov_core/src/feat/FeatureInitializer.{h,cpp}`), with the feature batch
as a written-out leading dimension F:

  * `triangulate_linear`: the linear A p = b accumulation with
    condition-number and depth gating (`single_triangulation`);
  * `triangulate_1d`: the depth-only solve along the anchor bearing
    (`single_triangulation_1d`);
  * `refine_gauss_newton`: inverse-depth GN refinement with a fixed
    iteration count (`single_gaussnewton`), with its Jacobian in closed
    form.

Observations are normalized image coordinates with masks; camera poses
are (R_GtoC (F,M,3,3), p_CinG (F,M,3)) over M = clone slots x cameras.
"""

from __future__ import annotations

import math

import torch

from ..filter.ekf import cholesky_or_nan
from ..math import skew

_GN_ITERS = 5


def _eigvals_sym3(A):
    """Ascending eigenvalues of symmetric 3x3 matrices (closed-form
    trigonometric method), batched."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = (B * B).sum((-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / (2.0 * p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e3, e2, e1], dim=-1)


def _cho_solve(A, b):
    """Solve SPD systems A x = b (batched, b a vector per system)."""
    return torch.cholesky_solve(b[..., None], cholesky_or_nan(A))[..., 0]


def triangulate_linear(uvn, mask, R_GtoC, p_CinG, min_depth=0.1, max_depth=60.0, max_cond=10000.0):
    """Linear triangulation in the global frame, batched over features.

    uvn (F,M,2), mask (F,M), R_GtoC (F,M,3,3), p_CinG (F,M,3).
    Returns (p_FinG (F,3), ok (F,)).
    """
    b_C = torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1)
    b_G = (R_GtoC.transpose(-1, -2) @ b_C[..., None])[..., 0]
    b_G = b_G / torch.linalg.vector_norm(b_G, dim=-1, keepdim=True)
    N = skew(b_G)  # (F,M,3,3)
    NtN = N.transpose(-1, -2) @ N
    w = mask[..., None, None].to(uvn.dtype)
    A = (w * NtN).sum(-3)  # (F,3,3)
    bvec = (NtN @ p_CinG[..., None])[..., 0]
    bsum = (mask[..., None] * bvec).sum(-2)
    evals = _eigvals_sym3(A)
    cond = evals[..., -1] / torch.clamp(evals[..., 0], min=1e-18)
    A_safe = A + 1e-12 * torch.eye(3, dtype=A.dtype, device=A.device)
    p = _cho_solve(A_safe, bsum)  # (F,3)
    z = (R_GtoC @ (p[:, None, :] - p_CinG)[..., None])[..., 2, 0]  # (F,M)
    depth_ok = torch.where(mask, (z > min_depth) & (z < max_depth), torch.ones_like(mask)).all(-1)
    ok = (cond < max_cond) & depth_ok & (mask.sum(-1) >= 2) & torch.isfinite(p).all(-1)
    return torch.where(ok[:, None], p, torch.zeros_like(p)), ok


def _first_true(mask):
    """Index of the first True per row (0 if none), as `jnp.argmax`."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _take(x, idx):
    """x[f, idx[f]] for a per-feature index."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def refine_gauss_newton(p0, uvn, mask, R_GtoC, p_CinG, max_baseline=40.0):
    """Fixed-iteration GN refinement over inverse-depth coordinates
    (alpha, beta, rho) in the first valid camera's frame, with the
    reference's depth and depth/baseline acceptance gates. Batched over
    features; returns (p_refined (F,3), ok (F,))."""
    dtype = p0.dtype
    idx = _first_true(mask)
    R_GtoA = _take(R_GtoC, idx)  # (F,3,3)
    p_AinG = _take(p_CinG, idx)  # (F,3)
    p_inA = (R_GtoA @ (p0 - p_AinG)[..., None])[..., 0]
    z = torch.where(p_inA[:, 2].abs() < 1e-6, torch.full_like(p_inA[:, 2], 1e-6), p_inA[:, 2])
    x = torch.stack([p_inA[:, 0] / z, p_inA[:, 1] / z, 1.0 / z], dim=-1)  # (F,3)

    R_AtoC = R_GtoC @ R_GtoA[:, None].transpose(-1, -2)  # (F,M,3,3)
    p_AinC = (R_GtoC @ (p_AinG[:, None] - p_CinG)[..., None])[..., 0]  # (F,M,3)
    m = mask.to(dtype)[..., None]  # (F,M,1)
    eye3 = torch.eye(3, dtype=dtype, device=p0.device)
    # dh/dx columns: R_AtoC[:, :, :, 0], R_AtoC[:, :, :, 1], p_AinC
    dh_dx = torch.cat([R_AtoC[..., :, 0:2], p_AinC[..., None]], dim=-1)  # (F,M,3,3)

    for _ in range(_GN_ITERS):
        ab1 = torch.cat([x[:, :2], torch.ones_like(x[:, :1])], dim=-1)
        h = (R_AtoC @ ab1[:, None, :, None])[..., 0] + x[:, None, 2:3] * p_AinC  # (F,M,3)
        tiny = h[..., 2].abs() < 1e-9
        hz = torch.where(tiny, torch.full_like(h[..., 2], 1e-9), h[..., 2])
        r = (h[..., :2] / hz[..., None] - uvn) * m  # (F,M,2)
        # d pred / d h, with hz's derivative cut where it was clamped
        dhz = torch.where(tiny, torch.zeros_like(hz), torch.ones_like(hz))
        zero = torch.zeros_like(hz)
        dpred_dh = torch.stack([
            torch.stack([1.0 / hz, zero, -h[..., 0] / hz**2 * dhz], dim=-1),
            torch.stack([zero, 1.0 / hz, -h[..., 1] / hz**2 * dhz], dim=-1),
        ], dim=-2)  # (F,M,2,3)
        J = (dpred_dh @ dh_dx) * m[..., None]  # (F,M,2,3)
        J = J.reshape(J.shape[0], -1, 3)
        r = r.reshape(r.shape[0], -1)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye3
        x = x - _cho_solve(JtJ, (J.transpose(-1, -2) @ r[..., None])[..., 0])

    alpha, beta, rho = x[:, 0], x[:, 1], x[:, 2]
    ok = rho > 1e-4
    safe_rho = torch.where(ok, rho, torch.ones_like(rho))
    p_inA_new = torch.stack([alpha / safe_rho, beta / safe_rho, 1.0 / safe_rho], dim=-1)
    nrm = torch.linalg.vector_norm(p_inA_new, dim=-1)
    dirn = p_inA_new / torch.clamp(nrm, min=1e-9)[:, None]
    p_CinA = ((p_CinG - p_AinG[:, None]) @ R_GtoA.transpose(-1, -2))  # (F,M,3)
    orth = p_CinA - (p_CinA * dirn[:, None]).sum(-1, keepdim=True) * dirn[:, None]
    base = torch.where(mask, torch.linalg.vector_norm(orth, dim=-1), torch.zeros_like(orth[..., 0]))
    base_max = base.max(dim=-1).values
    ratio_ok = nrm < max_baseline * torch.clamp(base_max, min=1e-12)
    ok = ok & ratio_ok & torch.isfinite(p_inA_new).all(-1)
    p_new = (R_GtoA.transpose(-1, -2) @ p_inA_new[..., None])[..., 0] + p_AinG
    return torch.where(ok[:, None], p_new, p0), ok


def triangulate_1d(uvn, mask, R_GtoC, p_CinG, min_depth=0.1, max_depth=60.0):
    """Depth-only (1D) triangulation along the anchor bearing, batched
    over features (`single_triangulation_1d`, `FeatureInitializer.cpp:
    114-195`): the anchor is the last valid observation; every other
    observation's bearing, rotated into the anchor frame, contributes a
    scalar least-squares row ||skew(b_i) (d b_A - p_CiinA)||^2, solved in
    closed form for the depth d.

    uvn (F,M,2), mask (F,M), R_GtoC (F,M,3,3), p_CinG (F,M,3).
    Returns (p_FinG (F,3), ok (F,)).
    """
    M = mask.shape[-1]
    a_idx = M - 1 - _first_true(mask.flip(-1))
    R_GtoA = _take(R_GtoC, a_idx)  # (F,3,3)
    p_AinG = _take(p_CinG, a_idx)  # (F,3)
    b_C = torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1)
    b_a = _take(b_C, a_idx)
    b_A_anchor = b_a / torch.linalg.vector_norm(b_a, dim=-1, keepdim=True)

    # every bearing into the anchor frame: b_i^A = R_AtoCi^T b_i
    R_AtoC = R_GtoC @ R_GtoA[:, None].transpose(-1, -2)  # (F,M,3,3)
    b_inA = (R_AtoC.transpose(-1, -2) @ b_C[..., None])[..., 0]
    b_inA = b_inA / torch.clamp(torch.linalg.vector_norm(b_inA, dim=-1, keepdim=True), min=1e-12)
    p_CinA = (p_CinG - p_AinG[:, None]) @ R_GtoA.transpose(-1, -2)  # (F,M,3)

    Bperp = skew(b_inA)  # (F,M,3,3)
    Ba = (Bperp @ b_A_anchor[:, None, :, None])[..., 0]  # (F,M,3)
    use = mask & (torch.arange(M, device=mask.device) != a_idx[:, None])
    w = use.to(uvn.dtype)
    A = (w * (Ba * Ba).sum(-1)).sum(-1)
    b = (w * (Ba * (Bperp @ p_CinA[..., None])[..., 0]).sum(-1)).sum(-1)
    depth = b / torch.where(A.abs() < 1e-12, torch.ones_like(A), A)
    p_inA = depth[:, None] * b_A_anchor
    ok = (
        (p_inA[:, 2] > min_depth)
        & (p_inA[:, 2] < max_depth)
        & (use.sum(-1) >= 1)
        & torch.isfinite(p_inA).all(-1)
    )
    p_G = (R_GtoA.transpose(-1, -2) @ p_inA[..., None])[..., 0] + p_AinG
    return torch.where(ok[:, None], p_G, torch.zeros_like(p_G)), ok


def triangulate_batch(uvn, mask, R_GtoC, p_CinG, refine=True, max_baseline=40.0, use_1d=False):
    """Triangulate (+ refine) a feature batch.

    uvn (F,M,2), mask (F,M), R_GtoC (F,M,3,3) or (M,3,3) shared, p_CinG
    likewise. `use_1d` selects the depth-only anchor-ray solve (the
    reference's `triangulate_1d` option); `refine` the Gauss-Newton
    refinement. Returns (p_FinG (F,3), ok (F,)).
    """
    F = uvn.shape[0]
    if R_GtoC.ndim == 3:
        R_GtoC = R_GtoC.expand(F, *R_GtoC.shape)
        p_CinG = p_CinG.expand(F, *p_CinG.shape)
    tri = triangulate_1d if use_1d else triangulate_linear
    p_lin, ok_lin = tri(uvn, mask, R_GtoC, p_CinG)
    if not refine:
        return p_lin, ok_lin
    p_ref, ok_ref = refine_gauss_newton(p_lin, uvn, mask, R_GtoC, p_CinG, max_baseline=max_baseline)
    return torch.where(ok_lin[:, None], p_ref, p_lin), ok_lin & ok_ref

"""Bundle adjustment over keyframes and landmarks, one device or sharded.

Port of `uvio_tpu/parallel/ba.py`: a damped Gauss-Newton solve whose
camera system is the Schur complement over the landmarks

    S  = H_pp - H_pl H_ll^-1 H_pl^T      (6N x 6N)
    b  = b_p  - H_pl H_ll^-1 b_l

solved with a Cholesky factor (tiny: 6N for N keyframes) and
back-substituted into the landmarks.

Sharding: with a `mesh` from `parallel.distributed` (`make_ba_mesh`,
`make_lm_mesh`) every process of a `torch.distributed` group runs this
function on the same full inputs and computes its own shard, and the
collectives of `uvio_tpu`'s `shard_map` become process-group collectives:

- 1-D landmark sharding (mesh axes ("lm",)): each process holds L/P
  landmarks; S, b and the cost are `all_reduce`d (SUM).
- 2-D keyframe x landmark sharding (axes ("kf", "lm")): the (L, N)
  observation blocks are tiled over the grid; the per-landmark A and b_l
  are `all_reduce`d over "kf", the pose blocks Hpl, Hpp_diag and b_p
  `all_gather`ed over "kf" in rank order (JAX's `tiled=True`), S and b
  `all_reduce`d over "lm" and the cost over both.

The landmarks come back whole (an `all_gather` over "lm" after the last
iteration). Only the order of the sums differs from the one-device solve.

Geometry: keyframe pose = (q_GtoC JPL, p_CinG), the camera pose directly;
observations are normalized image coordinates with masks; landmarks are
global 3D points. The first `fix_poses` keyframes hold the gauge, and
Levenberg damping handles the remaining weak directions.

The Levenberg loop is a fixed-count Python loop; the accept/reject is a
`torch.where` select and the per-iteration costs stay on the device, so
nothing inside the loop waits for the host (`cholesky_ex` with
`check_errors=False`, not `cholesky`, which checks its error code on the
host).
"""

from __future__ import annotations

import dataclasses

import torch

from ..math import quat_multiply, quat_norm, quat_to_rot, skew


@dataclasses.dataclass
class BAOptions:
    iters: int = 15
    damping_init: float = 1e-4
    huber_norm: float = 5e-3  # robust threshold in normalized units
    fix_poses: int = 1  # number of leading keyframes held fixed


def _residual_jacobians(q, p, lm):
    """Per-(landmark, keyframe) residual pieces.

    q (N,4) JPL q_GtoC, p (N,3) p_CinG, lm (L,3).
    Returns pred (L,N,2), Jp (L,N,2,6) wrt [theta, p] of the pose,
    Jl (L,N,2,3) wrt the landmark, depth z (L,N).
    """
    R = quat_to_rot(q)  # (N,3,3)
    d = lm[:, None, :] - p[None, :, :]  # (L,N,3)
    pc = torch.einsum("nij,lnj->lni", R, d)  # p in the camera frame
    z = pc[..., 2]
    safe_z = torch.where(z.abs() < 1e-3, torch.full_like(z, 1e-3), z)
    pred = pc[..., :2] / safe_z[..., None]
    one = torch.ones_like(safe_z)
    zero = torch.zeros_like(safe_z)
    Hproj = torch.stack(
        [
            torch.stack([one / safe_z, zero, -pc[..., 0] / safe_z**2], dim=-1),
            torch.stack([zero, one / safe_z, -pc[..., 1] / safe_z**2], dim=-1),
        ],
        dim=-2,
    )  # (L,N,2,3)
    # d pc/d theta = [pc]_x (JPL left error), d pc/d p = -R, d pc/d lm = R
    Jp_th = Hproj @ skew(pc)
    Jl = torch.einsum("lnab,nbe->lnae", Hproj, R)
    Jp = torch.cat([Jp_th, -Jl], dim=-1)  # (L,N,2,6)
    return pred, Jp, Jl, z


def _weighted(q, p, lm, obs, mask, huber):
    """Huber-weighted residuals and Jacobians of one observation block:
    (r (L,N,2), Jp (L,N,2,6), Jl (L,N,2,3)), each scaled by sqrt(w)."""
    pred, Jp, Jl, z = _residual_jacobians(q, p, lm)
    m = mask.to(pred.dtype)
    r = (obs - pred) * m[..., None]
    rn = torch.linalg.vector_norm(r, dim=-1)
    w = torch.where(rn > huber, huber / torch.clamp(rn, min=1e-12), torch.ones_like(rn))
    w = w * m * (z > 0.05)
    sw = torch.sqrt(w)[..., None]
    return r * sw, Jp * sw[..., None], Jl * sw[..., None]


def _local_pieces(q, p, lm_shard, obs_shard, mask_shard, huber):
    """Raw Gauss-Newton pieces for one (landmark shard x keyframe shard)
    observation block; q/p may be a keyframe shard (Nk rows).

    Returns (A (Ls,3,3), b_l (Ls,3), Hpl (Ls,Nk,6,3), Hpp_diag (Nk,6,6),
    b_p (Nk,6), cost), all partial sums over the local block.
    """
    r, Jp, Jl = _weighted(q, p, lm_shard, obs_shard, mask_shard, huber)
    A = torch.einsum("lnai,lnaj->lij", Jl, Jl)
    b_l = torch.einsum("lnai,lna->li", Jl, r)
    Hpl = Jp.transpose(-1, -2) @ Jl  # (Ls,Nk,6,3)
    Hpp_diag = torch.einsum("lnai,lnaj->nij", Jp, Jp)
    b_p = torch.einsum("lnai,lna->ni", Jp, r)
    cost = (r * r).sum()
    return A, b_l, Hpl, Hpp_diag, b_p, cost


def _local_cost(q, p, lm_shard, obs_shard, mask_shard, huber):
    """The cost term of `_local_pieces` alone (the accept test's)."""
    r, _, _ = _weighted(q, p, lm_shard, obs_shard, mask_shard, huber)
    return (r * r).sum()


def _block_diag(blocks):
    """(N,6,6) -> the (6N,6N) block-diagonal matrix, in one op."""
    N, b, _ = blocks.shape
    eye = torch.eye(N, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("nij,nm->nimj", blocks, eye).reshape(N * b, N * b)


def _schur_combine(A, b_l, Hpl, Hpp_diag, b_p, cost):
    """The Schur-reduced camera system from (possibly collective-combined)
    full-keyframe pieces. Hpl (Ls,N,6,3), Hpp_diag (N,6,6)."""
    N = Hpp_diag.shape[0]
    A_reg = A + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    A_inv = _inv3(A_reg)
    # Schur: S -= B A^-1 B^T with B (6N,3) per landmark
    B = Hpl.reshape(Hpl.shape[0], N * 6, 3)
    BAinv = B @ A_inv  # (Ls,6N,3)
    S_red = torch.einsum("lpk,lqk->pq", BAinv, B)
    b_red = torch.einsum("lpk,lk->p", BAinv, b_l)
    S = _block_diag(Hpp_diag) - S_red
    b = b_p.reshape(N * 6) - b_red
    return S, b, A_inv, B


def _schur_contrib(q, p, lm_shard, obs_shard, mask_shard, huber):
    """One landmark shard's Schur pieces (full keyframe axis).

    Returns (S (6N,6N), b (6N,), A_inv (Ls,3,3), B (Ls,6N,3),
    b_l (Ls,3), cost).
    """
    A, b_l, Hpl, Hpp_diag, b_p, cost = _local_pieces(q, p, lm_shard, obs_shard, mask_shard, huber)
    S, b, A_inv, B = _schur_combine(A, b_l, Hpl, Hpp_diag, b_p, cost)
    return S, b, A_inv, B, b_l, cost


def _inv3(A):
    """Batched closed-form 3x3 inverse (adjugate over a guarded
    determinant: a singular block, as a masked landmark's, gives zeros
    instead of infinities, so padded rows stay exactly inert)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = -(d * i - f * g)
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02
    safe = torch.where(det.abs() < 1e-18, torch.ones_like(det), det)
    adj = torch.stack(
        [
            torch.stack([co00, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([co01, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([co02, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj / safe[..., None, None]


class _Single:
    """The one-device contribution: the whole problem is the shard."""

    def __init__(self, obs_uv, obs_mask, huber):
        self.uv, self.m, self.huber = obs_uv, obs_mask, huber

    def local_lm(self, lm):
        return lm

    def contrib(self, q, p, lm):
        return _schur_contrib(q, p, lm, self.uv, self.m, self.huber)

    def cost(self, q, p, lm):
        return _local_cost(q, p, lm, self.uv, self.m, self.huber)

    def gather_lm(self, lm):
        return lm


def _all_reduce(x, group):
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_gather(x, group, dim):
    """JAX's tiled `all_gather`: the group's shards concatenated along
    `dim` in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Sharded:
    """A process's shard of the sharded contribution (`mesh` from
    `parallel.distributed`): landmarks by the "lm" coordinate and, on a
    2-D mesh, keyframes by the "kf" coordinate."""

    def __init__(self, mesh, obs_uv, obs_mask, huber):
        L, N = obs_mask.shape
        n_lm, n_kf = mesh.size("lm"), mesh.size("kf")
        if L % n_lm or N % n_kf:
            raise ValueError(f"(L={L}, N={N}) does not divide over the mesh (lm={n_lm}, kf={n_kf})")
        self.mesh, self.huber = mesh, huber
        Ls, Nk = L // n_lm, N // n_kf
        self.lm_rows = slice(mesh.index("lm") * Ls, (mesh.index("lm") + 1) * Ls)
        self.kf_cols = slice(mesh.index("kf") * Nk, (mesh.index("kf") + 1) * Nk)
        self.uv = obs_uv[self.lm_rows, self.kf_cols]
        self.m = obs_mask[self.lm_rows, self.kf_cols]
        self.two_d = "kf" in mesh.axis_names

    def local_lm(self, lm):
        return lm[self.lm_rows]

    def contrib(self, q, p, lm):
        g = self.mesh.group
        if not self.two_d:
            S, b, A_inv, B, b_l, cost = _schur_contrib(q, p, lm, self.uv, self.m, self.huber)
            return _all_reduce(S, g("lm")), _all_reduce(b, g("lm")), A_inv, B, b_l, _all_reduce(cost, g("lm"))
        A, b_l, Hpl, Hpp_diag, b_p, cost = _local_pieces(
            q[self.kf_cols], p[self.kf_cols], lm, self.uv, self.m, self.huber
        )
        # per-landmark pieces: sum over the keyframe axis
        A, b_l = _all_reduce(A, g("kf")), _all_reduce(b_l, g("kf"))
        # pose-block pieces: concatenate the keyframe axis
        Hpl = _all_gather(Hpl, g("kf"), 1)
        Hpp_diag = _all_gather(Hpp_diag, g("kf"), 0)
        b_p = _all_gather(b_p, g("kf"), 0)
        S, b, A_inv, B = _schur_combine(A, b_l, Hpl, Hpp_diag, b_p, cost)
        # reduced camera system: sum the landmark shards
        return _all_reduce(S, g("lm")), _all_reduce(b, g("lm")), A_inv, B, b_l, _all_reduce(cost, g("all"))

    def cost(self, q, p, lm):
        if not self.two_d:
            return _all_reduce(_local_cost(q, p, lm, self.uv, self.m, self.huber), self.mesh.group("lm"))
        c = _local_cost(q[self.kf_cols], p[self.kf_cols], lm, self.uv, self.m, self.huber)
        return _all_reduce(c, self.mesh.group("all"))

    def gather_lm(self, lm):
        return _all_gather(lm, self.mesh.group("lm"), 0)


def ba_solve(q0, p0, lm0, obs_uv, obs_mask, opts: BAOptions = BAOptions(), mesh=None, pose_valid=None):
    """Damped Gauss-Newton BA. q0 (N,4), p0 (N,3), lm0 (L,3), obs_uv
    (L,N,2) normalized, obs_mask (L,N).

    With a `mesh` (see the module docstring) every process passes the same
    full inputs and gets the same full outputs; without one the solve runs
    on the inputs' device, with identical math.

    `pose_valid` (N,) bool marks live keyframe slots; invalid slots are
    held fixed (zero update, unit diagonal), so callers can pad the
    keyframe axis to a static size; landmark padding is inert through
    all-zero `obs_mask` rows.
    Returns (q, p, lm, {"costs": (iters,) tensor}).
    """
    N = q0.shape[0]
    dtype, device = p0.dtype, p0.device
    fixmask = torch.cat([torch.zeros(6 * opts.fix_poses, dtype=dtype, device=device),
                         torch.ones(6 * (N - opts.fix_poses), dtype=dtype, device=device)])
    if pose_valid is not None:
        fixmask = fixmask * torch.repeat_interleave(pose_valid.to(dtype), 6)
    prob = _Single(obs_uv, obs_mask, opts.huber_norm) if mesh is None else _Sharded(
        mesh, obs_uv, obs_mask, opts.huber_norm)

    q, p, lm = q0, p0, prob.local_lm(lm0)
    lam = torch.full((), opts.damping_init, dtype=dtype, device=device)
    ones = torch.ones((N, 1), dtype=dtype, device=device)
    costs = []
    for _ in range(opts.iters):
        S, b, A_inv, B, b_l, cost = prob.contrib(q, p, lm)
        # gauge fixing + damping
        S = S * fixmask[:, None] * fixmask[None, :]
        S = S + torch.diag((1.0 - fixmask) + lam * (torch.diagonal(S) + 1e-6))
        b = b * fixmask
        chol = torch.linalg.cholesky_ex(S, check_errors=False).L
        dx_p = torch.cholesky_solve(b[:, None], chol)[:, 0]  # (6N,)
        # landmark back-substitution: dx_l = A^-1 (b_l - B^T dx_p)
        dx_l = (A_inv @ (b_l - torch.einsum("lpk,p->lk", B, dx_p))[..., None])[..., 0]

        dxp = dx_p.reshape(N, 6)
        dq = quat_norm(torch.cat([0.5 * dxp[:, :3], ones], dim=1))
        q_new = quat_multiply(dq, q)
        p_new = p + dxp[:, 3:]
        lm_new = lm + dx_l

        # accept if better (the new linearization's cost)
        better = prob.cost(q_new, p_new, lm_new) < cost
        q = torch.where(better, q_new, q)
        p = torch.where(better, p_new, p)
        lm = torch.where(better, lm_new, lm)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        costs.append(cost)
    costs = torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=device)
    return q, p, prob.gather_lm(lm), {"costs": costs}

"""Dynamic (in-motion) initialization.

Port of `uvio_tpu/init/dynamic_init.py` (the reference's
`ov_init/src/dynamic/DynamicInitializer.cpp`): recover orientation
(gravity), velocity, biases and feature depths from a short window while
moving. As in `uvio_tpu`, the poses inside the window are not free
variables: they are shot from (v0, g, bg, ba) through the
preintegration of `init/cpi.py`, so the IMU factors hold exactly and the
MLE is reprojection residuals plus bias and gravity-magnitude priors,
solved by a damped Gauss–Newton after a linear bootstrap of
[v0, g, features] from the bearing cross-product system
(`DynamicInitializer.cpp:355-389`).

Jacobian route: `torch.func.jacfwd` over the residual, the same
forward-mode derivative that `uvio_tpu` takes with `jax.jacfwd`. It
pushes all 12 + 3F tangents through one pass of the residual as a batch
dimension, so a Jacobian costs the launches of one residual with wider
tensors (the residual's own value comes out of the same pass), and it
matches the reference's derivatives to rounding without a hand-derived
chain rule through the shooting and projection to keep in step. Its cost
is on the host: the batching of every operator of the IMU loop, once a
step. On a CUDA device the steps after the first therefore replay one
captured CUDA graph of a step (`_gn_on_graph`), so an attempt pays that
host work about four times whatever `gn_iters` is.

Shapes are static: P pose times, padded IMU slices between them, F
padded feature tracks. The solver runs in float64 on the caller's device
and runs once per attempt; its gates are host floats, as in the
reference, and it reads back once to cut the IMU loop at the last
sample any interval holds (`cpi.active_pairs`), which leaves the result
unchanged: the pairs after it are identity steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..math import quat_to_rot, rot_to_quat, skew
from .cpi import active_pairs, preintegrate, preintegrate_v1
from .static_init import gravity_aligned_quat


@dataclasses.dataclass
class DynamicInitOptions:
    num_pose: int = 6  # init_dyn_num_pose
    max_features: int = 25  # init_max_features
    gn_iters: int = 10  # init_dyn_mle_max_iter
    sigma_pix_norm: float = 2e-3  # reprojection sigma in normalized units
    bias_prior: float = 0.1
    gravity_mag: float = 9.81
    min_features: int = 8
    max_reproj_rmse: float = 5e-3  # acceptance gate (normalized units)
    # remaining reference knob set (`InertialInitializerOptions.h:64-116`)
    min_deg: float = 10.0  # init_dyn_min_deg: rotation gate before trying
    min_rec_cond: float = 1e-15  # init_dyn_min_rec_cond: Hessian rcond gate
    # covariance inflation of the seeded prior (applied as
    # sigma = base_sigma * sqrt(inflation); the defaults reproduce the
    # reference defaults 10/10/100/100)
    inflation_ori: float = 10.0  # init_dyn_inflation_orientation
    inflation_vel: float = 10.0  # init_dyn_inflation_velocity
    inflation_bg: float = 100.0  # init_dyn_inflation_bias_gyro
    inflation_ba: float = 100.0  # init_dyn_inflation_bias_accel
    # initial bias seeds for the MLE (init_dyn_bias_{g,a})
    init_bias_g: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    init_bias_a: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # init_dyn_mle_opt_calib: parsed for config parity but NOT applied:
    # the reference itself ships it default-off and warns it is unstable;
    # calibration states refine online in the filter instead
    mle_opt_calib: bool = False
    # preintegration model: "midpoint" (autodiff midpoint scheme) or
    # "cpi_v1" (the reference's closed-form CpiV1, `cpi/CpiV1.cpp`)
    cpi_model: str = "midpoint"


def _shoot_poses(cpis, v0, g):
    """Cumulative poses in the I0 frame from per-interval preintegrals.

    cpis: dict of stacked (P-1,...) preintegrals. Returns R_0p (P,3,3),
    p (P,3), v (P,3), all in the I0 frame (p_0 = 0, R_00 = I)."""
    eye = torch.eye(3, dtype=v0.dtype, device=v0.device)
    R0p, p, v = eye, torch.zeros_like(v0), v0
    Rs, ps, vs = [R0p], [p], [v]
    for i in range(cpis["dt"].shape[0]):
        dt = cpis["dt"][i]
        p = p + v * dt - 0.5 * g * dt * dt + R0p.mT @ cpis["alpha"][i]
        v = v - g * dt + R0p.mT @ cpis["beta"][i]
        R0p = cpis["R_k2tau"][i] @ R0p
        Rs.append(R0p)
        ps.append(p)
        vs.append(v)
    return torch.stack(Rs), torch.stack(ps), torch.stack(vs)


def _preintegrals(opts, imu, bg, ba, n_pairs):
    pre = preintegrate_v1 if opts.cpi_model == "cpi_v1" else preintegrate
    return pre(*imu, bg, ba, n_pairs=n_pairs)


def _reproj_residuals(params, cpi_inputs, obs_uvn, obs_mask, R_ItoC, p_IinC, opts, n_pairs=None):
    """Stacked residual vector for the GN.

    params: dict with v0 (3,), g (3,), bg (3,), ba (3,), feats (F,3).
    cpi_inputs: (imu_t (P-1,M), imu_w (P-1,M,3), imu_a (P-1,M,3)).
    obs_uvn (F,P,2) normalized obs; obs_mask (F,P) (float or bool)."""
    cpis = _preintegrals(opts, cpi_inputs, params["bg"], params["ba"], n_pairs)
    R0p, p0p, _ = _shoot_poses(cpis, params["v0"], params["g"])

    # p_FinC[f,p] = R_ItoC R_0p (x_f - p_p) + p_IinC
    d = params["feats"][:, None, :] - p0p[None, :, :]
    p_inI = torch.einsum("pij,fpj->fpi", R0p, d)
    p_inC = torch.einsum("ij,fpj->fpi", R_ItoC, p_inI) + p_IinC[None, None]
    z = p_inC[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-3, torch.full_like(z, 1e-3), z)
    pred = p_inC[..., :2] / safe_z[..., None]
    r_uv = (pred - obs_uvn) * obs_mask.to(pred.dtype)[..., None] / opts.sigma_pix_norm
    r_bias = torch.cat([params["bg"], params["ba"]]) / opts.bias_prior
    r_grav = (torch.linalg.vector_norm(params["g"]) - opts.gravity_mag).reshape(1) / 1e-3
    return torch.cat([r_uv.reshape(-1), r_bias, r_grav])


def _flatten(params):
    return torch.cat([params["v0"], params["g"], params["bg"], params["ba"], params["feats"].reshape(-1)])


def _unflatten(x, F):
    return {"v0": x[0:3], "g": x[3:6], "bg": x[6:9], "ba": x[9:12], "feats": x[12:].reshape(F, 3)}


def _cholesky(A):
    """Lower Cholesky factor, NaN where the factorization fails (what
    `jax.scipy.linalg.cho_factor` gives; `torch.linalg.cholesky` would
    raise)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where(info[..., None, None] == 0, L, torch.full_like(L, float("nan")))


def _bootstrap_system(cpis, obs_uvn, obs_mask, R_ItoC, p_IinC):
    """The stacked bearing constraints of the linear bootstrap,
    [b]_x (R_ItoC R_0p x_f - R_ItoC R_0p p_p + p_IinC) = 0 with
    p_p = A_p v0 + B_p g + c_p, as (F*P*2, 6+3F) rows and (F*P*2,)
    right-hand side, built in one vectorised pass (the reference
    `vmap`s `obs_rows` over (f, p) and places each block with
    `dynamic_update_slice`)."""
    dtype, dev = obs_uvn.dtype, obs_uvn.device
    F, P = obs_uvn.shape[:2]
    eye = torch.eye(3, dtype=dtype, device=dev)
    z33 = torch.zeros((3, 3), dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    # pose coefficients p_p = Ap v0 + Bp g + cp (the recursion in closed form)
    R0p, Ap, Bp, cp, Av, Bv, cv = eye, z33, z33, z3, eye, z33, z3
    Rs, As, Bs, cs = [eye], [z33], [z33], [z3]
    for i in range(cpis["dt"].shape[0]):
        dt = cpis["dt"][i]
        Ral = R0p.mT @ cpis["alpha"][i]
        Rbe = R0p.mT @ cpis["beta"][i]
        Ap = Ap + Av * dt
        Bp = Bp + Bv * dt - 0.5 * dt * dt * eye
        cp = cp + cv * dt + Ral
        Bv = Bv - dt * eye
        cv = cv + Rbe
        R0p = cpis["R_k2tau"][i] @ R0p
        Rs.append(R0p)
        As.append(Ap)
        Bs.append(Bp)
        cs.append(cp)
    R_all, A_all, B_all, c_all = (torch.stack(x) for x in (Rs, As, Bs, cs))

    b = torch.cat([obs_uvn, torch.ones((F, P, 1), dtype=dtype, device=dev)], dim=-1)
    Bx = skew(b)[..., :2, :]  # (F,P,2,3): 2 independent rows
    RC = R_ItoC @ R_all  # (P,3,3)
    row_f = Bx @ RC  # coefficient of x_f
    row_v0 = -row_f @ A_all
    row_g = -row_f @ B_all
    rhs = -(Bx @ (p_IinC - RC @ c_all[..., None])[..., 0][None, :, :, None])[..., 0]
    m = obs_mask.to(dtype)[..., None, None]
    # x_f's block sits at columns 6+3f: spread each row over a one-hot of f
    onehot = torch.eye(F, dtype=dtype, device=dev)[:, None, None, :, None]  # (F,1,1,F,1)
    feat_cols = (row_f[:, :, :, None, :] * onehot).reshape(F, P, 2, 3 * F)
    rows = torch.cat([row_v0, row_g, feat_cols], dim=-1) * m
    return rows.reshape(-1, 6 + 3 * F), (rhs * m[..., 0]).reshape(-1)


def solve_dynamic_init(imu_t, imu_w, imu_a, obs_uvn, obs_mask, R_ItoC, p_IinC, opts: DynamicInitOptions):
    """Solve one window. imu_* are (P-1, M) padded slices between the P
    pose times; obs_uvn (F,P,2), obs_mask (F,P). Returns a dict of
    results and diagnostics (tensors on the inputs' device):
    params, hessian, rmse_norm, rcond, n_obs, and `accepted`
    (gn_iters,) bool, whether each Gauss–Newton step was taken."""
    F = obs_uvn.shape[0]
    dtype, dev = obs_uvn.dtype, obs_uvn.device
    cpi_inputs = (imu_t, imu_w, imu_a)
    n_pairs = active_pairs(imu_t)

    # ---- linear bootstrap (zero-bias preintegration) ----
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    cpis = preintegrate(*cpi_inputs, zero3, zero3, n_pairs=n_pairs)
    Amat, bvec = _bootstrap_system(cpis, obs_uvn, obs_mask, R_ItoC, p_IinC)
    n_unk = Amat.shape[1]
    AtA = Amat.T @ Amat + 1e-10 * torch.eye(n_unk, dtype=dtype, device=dev)
    x_lin = torch.cholesky_solve((Amat.T @ bvec)[:, None], _cholesky(AtA))[:, 0]

    g_lin = x_lin[3:6]
    g_scale = opts.gravity_mag / torch.clamp(torch.linalg.vector_norm(g_lin), min=1e-3)
    params = {
        "v0": x_lin[0:3],
        "g": g_lin * g_scale,
        "bg": torch.as_tensor(np.asarray(opts.init_bias_g), dtype=dtype, device=dev),  # init_dyn_bias_g seed
        "ba": torch.as_tensor(np.asarray(opts.init_bias_a), dtype=dtype, device=dev),
        "feats": x_lin[6:].reshape(F, 3),
    }

    # ---- damped Gauss-Newton MLE ----
    def res_fn(x):
        return _reproj_residuals(
            _unflatten(x, F), cpi_inputs, obs_uvn, obs_mask, R_ItoC, p_IinC, opts, n_pairs
        )

    # the Jacobian and the residual itself from one forward-mode pass
    jac_fn = torch.func.jacfwd(lambda x: (res_fn(x),) * 2, has_aux=True)

    def gn_step(x, lam):
        J, r = jac_fn(x)
        H = J.T @ J
        H = H + lam * torch.diag(torch.diagonal(H) + 1e-6)
        dx = torch.cholesky_solve((J.T @ r)[:, None], _cholesky(H))[:, 0]
        x_new = x - dx
        better = torch.sum(res_fn(x_new) ** 2) < torch.sum(r**2)
        return torch.where(better, x_new, x), torch.where(better, lam * 0.5, lam * 4.0), better

    x = _flatten(params)
    lam = torch.as_tensor(1e-3, dtype=dtype, device=dev)
    accepted = torch.zeros(opts.gn_iters, dtype=torch.bool, device=dev)
    if dev.type == "cuda" and opts.gn_iters > 1:
        x, lam = _gn_on_graph(gn_step, x, lam, accepted)
    else:
        for i in range(opts.gn_iters):
            x, lam, accepted[i] = gn_step(x, lam)
    p_opt = _unflatten(x, F)

    # final diagnostics + covariance (Laplace at the optimum)
    J, r = jac_fn(x)
    H = J.T @ J + 1e-6 * torch.eye(x.shape[0], dtype=dtype, device=dev)
    n_obs = obs_mask.to(dtype).sum()
    rmse = torch.sqrt(torch.sum(r[:-7] ** 2) * opts.sigma_pix_norm**2 / torch.clamp(2 * n_obs, min=1))
    # reciprocal condition number of the information over the IMU-state
    # block (v0,g,bg,ba): the reference gates covariance recovery on
    # rcond (init_dyn_min_rec_cond, `DynamicInitializer.cpp:~960-1010`)
    eigs = torch.linalg.eigvalsh(H[:12, :12])
    rcond = torch.abs(eigs[0]) / torch.clamp(torch.abs(eigs[-1]), min=1e-30)
    return {
        "params": p_opt,
        "hessian": H,
        "rmse_norm": rmse,
        "rcond": rcond,
        "n_obs": n_obs,
        "accepted": accepted,
    }


def _gn_on_graph(gn_step, x, lam, accepted):
    """Run the Gauss-Newton steps on a CUDA device: the first eagerly,
    which also warms up the solver libraries on the capture stream, then
    the same step captured once as a CUDA graph and replayed for the
    rest. The steps' own host work (the forward-mode batching of every
    operator of the IMU loop) is then paid twice instead of once a step.
    The replay runs the kernels of the eager step, so the result is the
    eager one. Writes `accepted` in place; returns the final x and lam."""
    stream = torch.cuda.Stream(device=x.device)
    stream.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(stream):
        x, lam, accepted[0] = gn_step(x, lam)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        x_next, lam_next, better = gn_step(x, lam)
        x.copy_(x_next)
        lam.copy_(lam_next)
    for i in range(1, accepted.shape[0]):
        graph.replay()
        accepted[i] = better
    return x, lam


def _to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _R_GtoI0(g_I0):
    q = gravity_aligned_quat(g_I0)
    return q, quat_to_rot(torch.as_tensor(q)).numpy()


def result_to_state_first(p_opt, opts):
    """Initial filter state at the FIRST pose time: gravity-aligned
    global frame with origin at p0 (the reference initializes at the
    oldest pose then fast-forwards, `VioManagerHelper.cpp:111-166`)."""
    q_GtoI0, R_GtoI0 = _R_GtoI0(_to_np(p_opt["g"]))
    return {
        "q_GtoI": q_GtoI0,
        "p": np.zeros(3),
        "v": R_GtoI0.T @ _to_np(p_opt["v0"]),
        "bg": _to_np(p_opt["bg"]),
        "ba": _to_np(p_opt["ba"]),
    }


def result_to_state(p_opt, imu_t, imu_w, imu_a, opts):
    """Map the solved window onto an initial filter state at the LAST
    pose time: gravity-aligned global frame anchored at p0 = 0."""
    cpis = preintegrate(imu_t, imu_w, imu_a, p_opt["bg"], p_opt["ba"])
    R0p, p0p, v0p = _shoot_poses(cpis, p_opt["v0"], p_opt["g"])
    _, R_GtoI0 = _R_GtoI0(_to_np(p_opt["g"]))
    R_GtoIP = _to_np(R0p[-1]) @ R_GtoI0
    return {
        "time": float(imu_t[-1, -1]),
        "q_GtoI": rot_to_quat(torch.as_tensor(R_GtoIP)).numpy(),
        "p": R_GtoI0.T @ _to_np(p0p[-1]),
        "v": R_GtoI0.T @ _to_np(v0p[-1]),
        "bg": _to_np(p_opt["bg"]),
        "ba": _to_np(p_opt["ba"]),
    }

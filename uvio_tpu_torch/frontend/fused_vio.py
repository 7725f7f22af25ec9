"""Device-resident image -> pose VIO step.

Port of `uvio_tpu/frontend/fused_vio.py`, the simplest deployment loop —
mono MSCKF odometry from raw images — as one function per frame:

    image -> hist-eq -> pyramid -> pyramidal LK [CUDA kernel, 4 levels]
    -> RANSAC -> FAST-9 [CUDA kernel] -> grid top-N refill
    -> propagate+clone -> slot-ring track triage -> MSCKF update
    -> marginalize -> pose out

Track bookkeeping is a (N_tracks, K_clones) ring history aligned with
the state's clone slots, so the padded MSCKF observation tensor is a
gather. Triage follows the reference (`VioManager.cpp:366-500`): lost
tracks and tracks observed at the clone about to be marginalized are
update candidates; the `max_msckf_in_update` longest are used.

On the card the step is captured once as a CUDA graph and replayed
every frame (`graphs.graphed`), as `uvio_tpu`'s tests run its step under
one `jax.jit`; both hand kernels launch inside the graph. RANSAC's
Gumbel noise is drawn before the replay, from the caller's generator,
and enters the graph as an input: the draws are those of the eager step.

Nothing in the step waits for the host. Where `uvio_tpu` branches with
`lax.cond`, the port computes the marginalized state and selects it
with `torch.where`; `mode="drop"` scatters write into an appended
sentinel row that is then dropped; duplicate scatter targets resolve to
the last writer, as `uvio_tpu`'s scatters do. The `ring_full` test
before the clone and the refill that keeps the old history row are
`uvio_tpu`'s behaviour (ROADMAP queue C), kept for parity.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..cam import models as cam_models
from ..device import resolve_device
from ..filter.ekf import marginalize_clone
from ..filter.propagator import NoiseManager, propagate_and_clone
from ..graphs import graphed
from ..types.layout import StateLayout
from ..update.msckf import msckf_update
from .klt import (
    RANSAC_HYPOTHESES,
    build_pyramid,
    fast_score,
    grid_detect,
    gumbel_noise,
    hist_equalize,
    lk_track,
    ransac_fundamental,
)


def check_full_precision():
    """Raise unless float32 matmuls and convolutions run in full float32:
    reduced-precision (TF32) products corrupt the EKF covariance (README
    "Numerics")."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.backends.cudnn.allow_tf32:
        raise RuntimeError("torch.backends.cudnn.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError('torch.get_float32_matmul_precision() must be "highest"')


def _last_writer(tgt: torch.Tensor, n_out: int) -> torch.Tensor:
    """(len(tgt),) bool: True where entry j is the last one to target
    tgt[j] (the write a sequential scatter keeps)."""
    j = torch.arange(tgt.shape[0], device=tgt.device)
    last = torch.full((n_out,), -1, dtype=torch.int64, device=tgt.device)
    last.scatter_reduce_(0, tgt, j, reduce="amax")
    return last[tgt] == j


def _scatter_drop(base: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """base.at[idx].set(values, mode="drop") along dim 0 for idx in
    [0, len(base)] (len(base) = the sentinel row), last writer wins."""
    n = base.shape[0]
    keep = _last_writer(idx, n + 1)
    idx = torch.where(keep, idx, torch.full_like(idx, n))
    ext = torch.cat([base, torch.zeros_like(base[:1])], dim=0)
    ext = ext.index_put((idx,), values.to(base.dtype).expand(idx.shape + base.shape[1:]))
    return ext[:n]


def make_fused_vio_step(
    layout: StateLayout,
    intrinsics,
    cam_model: int,
    *,
    device=None,
    num_features: int = 150,
    grid: Tuple[int, int] = (6, 8),
    levels: int = 4,
    half: int = 7,
    fast_thresh: float = 20.0,
    per_cell: int = 4,
    ransac_thresh: float = 2.0 / 450.0,
    noises: NoiseManager = None,
    gravity_mag: float = 9.81,
    integration: str = "rk4",
    sigma_pix: float = 1.0,
    chi2_mult: float = 1.0,
    max_msckf_in_update: int = 40,
):
    """Build (step_fn, make_carry).

    step_fn(state, carry, img, imu_t, imu_w, imu_a, stamp_time,
            gumbel=None, generator=None) -> (state, carry, info)
        img (H,W) float32, imu_* the padded window from
        `select_imu_readings_np` (imu_t and stamp_time float64), all on
        `device`. RANSAC uses `gumbel`, (64, 8, N) float32 Gumbel noise,
        when given, else draws it from `generator`.
    make_carry(img0) -> carry, the device-resident track state
        (pyramid list, uv, active, hist_uv, hist_mask).

    On CUDA inputs `step_fn` replays a CUDA graph captured at its first
    call (`graphs.graphed`); the noise is drawn before the replay, so the
    draws equal the eager step's. `step_fn.eager` is the eager step, with
    the same signature; `step_fn.graphed` the `graphs.Graphed` callable.
    The step is its two halves, also reachable as `step_fn.track` and
    `step_fn.update`:
      track(carry, img, gumbel, generator) -> (pyr, img_eq, uv_new, tracked)
      update(state, carry, pyr, img_eq, uv_new, tracked, imu_t, imu_w,
             imu_a, stamp_time) -> (state, carry, info)

    `layout.num_cams` must be 1 (mono odometry path). `device=None` is
    `default_device()`: the card, or an error without one.
    """
    if layout.num_cams != 1:
        raise ValueError("the fused path is mono")
    check_full_precision()
    device = resolve_device(device)
    noises = noises or NoiseManager()
    K = layout.max_clones
    N = num_features
    F = max_msckf_in_update
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
    ar_N = torch.arange(N, device=device)
    ar_K = torch.arange(K, device=device)

    def track(carry, img, gumbel=None, generator=None):
        """Frontend: hist-eq, pyramid, pyramidal LK, RANSAC."""
        pyr_prev, uv, active, _, _ = carry
        img_eq = hist_equalize(img)
        pyr = build_pyramid(img_eq, levels)
        uv_new, ok = lk_track(pyr_prev, pyr, uv, active, half=half)
        uvn1 = cam_models.undistort(intr, cam_model, uv)
        uvn2 = cam_models.undistort(intr, cam_model, uv_new)
        inl = ransac_fundamental(
            uvn1, uvn2, ok & active, ransac_thresh, gumbel=gumbel, generator=generator
        )
        return pyr, img_eq, uv_new, active & ok & inl

    def update(state, carry, pyr, img_eq, uv_new, tracked, imu_t, imu_w, imu_a, stamp_time):
        """Detection, filter and track bookkeeping for tracked tracks."""
        _, uv, active, hist_uv, hist_mask = carry
        score = fast_score(img_eq, fast_thresh)
        det_uv, det_ok = grid_detect(score, grid[0], grid[1], uv_new, tracked, per_cell=per_cell)

        # ---- propagate + stochastic clone ---------------------------
        ring_full = state.clones_valid.sum() >= K
        state = propagate_and_clone(
            state, layout, imu_t, imu_w, imu_a, noises, gravity_mag,
            integration=integration, stamp_time=stamp_time,
        )
        h = state.clone_head
        col_h = ar_K == h  # (K,) this frame's slot
        # oldest slot: the one the NEXT frame's clone would overwrite
        marg_slot = torch.remainder(h + 1, K)
        col_marg = ar_K == marg_slot

        # ---- record this frame's observations -----------------------
        hist_uv = torch.where(col_h[None, :, None], uv_new[:, None, :], hist_uv)
        hist_mask = torch.where(col_h[None, :], tracked[:, None], hist_mask)

        # ---- triage: lost + maxtrack-at-marg ------------------------
        lost = active & ~tracked
        maxtrack = tracked & (hist_mask & col_marg[None, :]).any(1) & ring_full
        cand = lost | maxtrack
        nobs = hist_mask.sum(1)
        tscore = torch.where(cand & (nobs >= 2), nobs, torch.full_like(nobs, -1))
        # stable descending sort: ties (all of them, integer counts) keep
        # the lower slot first, as `lax.top_k` does
        sel = torch.sort(tscore, descending=True, stable=True).indices[:F]
        sel_ok = tscore[sel] > 0
        obs_uv = hist_uv[sel][:, :, None, :]  # (F,K,1,2)
        obs_mask = hist_mask[sel][:, :, None] & sel_ok[:, None, None]

        # ---- MSCKF update -------------------------------------------
        state, minfo = msckf_update(
            state, layout, cam_model, obs_uv, obs_mask, sigma_pix=sigma_pix, chi2_mult=chi2_mult
        )

        # consume used candidates' measurements; maxtrack slots stay
        # active and restart their history from the next frame
        consumed = torch.zeros((N,), dtype=torch.bool, device=uv.device).index_put((sel,), sel_ok)
        hist_mask = hist_mask & ~consumed[:, None]
        active = tracked

        # ---- marginalize the oldest clone when the ring is full -----
        marg = marginalize_clone(state, layout, marg_slot)
        state = state.replace(
            cov=torch.where(ring_full, marg.cov, state.cov),
            clones_valid=torch.where(ring_full, marg.clones_valid, state.clones_valid),
            clones_t=torch.where(ring_full, marg.clones_t, state.clones_t),
        )
        hist_mask = hist_mask & ~(ring_full & col_marg)[None, :]

        # ---- refill free slots from detections ----------------------
        # rank-matched scatter: j-th valid detection -> j-th free slot
        free_rank = torch.cumsum(~active, 0) - 1
        det_rank = torch.cumsum(det_ok, 0) - 1
        slot_rank = torch.where(~active, free_rank, torch.full_like(free_rank, N + 1))
        slot_of_rank = _scatter_drop(
            torch.full((N + 2,), N + 1, dtype=torch.int64, device=uv.device),
            torch.clamp(slot_rank, 0, N + 1), ar_N,
        )
        tgt = torch.where(
            det_ok, slot_of_rank[torch.clamp(det_rank, 0, N + 1)], torch.full_like(det_rank, N + 1)
        )
        tgt = torch.clamp(tgt, max=N)  # every index past the end is dropped
        hit = _scatter_drop(torch.zeros_like(active), tgt, torch.ones_like(det_ok))
        new_uv = _scatter_drop(torch.zeros_like(uv_new), tgt, det_uv)
        uv_out = torch.where(hit[:, None], new_uv, uv_new)
        active = active | hit
        at_h = hit[:, None] & col_h[None, :]
        hist_uv = torch.where(at_h[..., None], new_uv[:, None, :], hist_uv)
        hist_mask = hist_mask | at_h

        carry = (pyr, uv_out, active, hist_uv, hist_mask)
        info = {
            "q": state.q, "p": state.p,
            "tracked": tracked,
            "num_tracks": active.sum(),
            "num_used": minfo["num_used"],
            "cov_ok": minfo["cov_ok"],
        }
        return state, carry, info

    def eager(state, carry, img, imu_t, imu_w, imu_a, stamp_time, gumbel=None, generator=None):
        pyr, img_eq, uv_new, tracked = track(carry, img, gumbel, generator)
        return update(state, carry, pyr, img_eq, uv_new, tracked, imu_t, imu_w, imu_a, stamp_time)

    replay = graphed(eager, "fused image->pose step")

    def step(state, carry, img, imu_t, imu_w, imu_a, stamp_time, gumbel=None, generator=None):
        if gumbel is None:
            gumbel = gumbel_noise((RANSAC_HYPOTHESES, 8, N), generator, img.device)
        return replay(state, carry, img, imu_t, imu_w, imu_a, stamp_time, gumbel)

    step.eager = eager
    step.graphed = replay
    step.track = track
    step.update = update

    def make_carry(img0):
        img0 = torch.as_tensor(img0, dtype=torch.float32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return (
            build_pyramid(hist_equalize(img0), levels),
            torch.zeros((N, 2), **f32),
            torch.zeros((N,), dtype=torch.bool, device=device),
            torch.zeros((N, K, 2), **f32),
            torch.zeros((N, K), dtype=torch.bool, device=device),
        )

    return step, make_carry

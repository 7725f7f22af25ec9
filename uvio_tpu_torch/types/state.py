"""Filter state: fixed-shape mean blocks + dense covariance, as tensors.

Port of `uvio_tpu/types/state.py`: every block is a fixed-size tensor
with a validity mask; the covariance is one dense (dim, dim) matrix laid
out by `StateLayout`. `*_fej` tensors hold the first-estimate
linearization points and are never touched by EKF updates.

Conventions: `q` is the JPL quaternion `q_GtoI`, `p`/`v` are in global,
`calib_cam_q/p` are `q_ItoC`/`p_IinC`. Integer fields are int64 (torch's
index type); `time` and `clones_t` are always float64.

The system carries no weights: state crosses between this package and
`uvio_tpu` as numpy arrays keyed by field name (`state_from_numpy` /
`state_to_numpy`, and `carry_*` for the fused step's track carry).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._pytree import register_pytree_node

from ..device import resolve_device
from .layout import IMU_MODEL_KALIBR, StateLayout


def dm_identity(imu_model: int):
    """The 6-vector whose `Dm` triangular fill is the identity matrix
    (KALIBR lower / RPNG upper column-wise fill, `State.h:91-102`)."""
    if imu_model == IMU_MODEL_KALIBR:
        return [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
    return [1.0, 0.0, 1.0, 0.0, 0.0, 1.0]


@dataclasses.dataclass(frozen=True)
class FilterState:
    time: torch.Tensor  # () f64
    q: torch.Tensor  # (4,) q_GtoI
    p: torch.Tensor  # (3,) p_IinG
    v: torch.Tensor  # (3,) v_IinG
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    q_fej: torch.Tensor
    p_fej: torch.Tensor
    v_fej: torch.Tensor
    clones_q: torch.Tensor  # (K,4)
    clones_p: torch.Tensor  # (K,3)
    clones_q_fej: torch.Tensor  # (K,4)
    clones_p_fej: torch.Tensor  # (K,3)
    clones_t: torch.Tensor  # (K,) f64
    clones_valid: torch.Tensor  # (K,) bool
    clone_head: torch.Tensor  # () int64, slot of newest clone (-1 if none)
    slam_p: torch.Tensor  # (S,3)
    slam_p_fej: torch.Tensor  # (S,3)
    slam_valid: torch.Tensor  # (S,) bool
    slam_id: torch.Tensor  # (S,) int64
    slam_anchor_slot: torch.Tensor  # (S,) int64
    slam_anchor_cam: torch.Tensor  # (S,) int64
    calib_imu_dw: torch.Tensor  # (6,)
    calib_imu_da: torch.Tensor  # (6,)
    calib_imu_tg: torch.Tensor  # (9,)
    calib_imu_gq: torch.Tensor  # (4,) q_GYROtoIMU
    calib_imu_aq: torch.Tensor  # (4,) q_ACCtoIMU
    calib_dt: torch.Tensor  # ()
    calib_cam_q: torch.Tensor  # (C,4) q_ItoC
    calib_cam_p: torch.Tensor  # (C,3) p_IinC
    calib_cam_intr: torch.Tensor  # (C,8)
    uwb_p_IinU: torch.Tensor  # (3,)
    anchors_p: torch.Tensor  # (A,3)
    anchors_gamma: torch.Tensor  # (A,)
    anchors_alpha: torch.Tensor  # (A,)
    anchors_valid: torch.Tensor  # (A,) bool
    cov: torch.Tensor  # (D,D)

    def replace(self, **changes) -> "FilterState":
        return dataclasses.replace(self, **changes)


_F64_FIELDS = ("time", "clones_t")
_BOOL_FIELDS = ("clones_valid", "slam_valid", "anchors_valid")
_INT_FIELDS = ("clone_head", "slam_id", "slam_anchor_slot", "slam_anchor_cam")
FIELDS = tuple(f.name for f in dataclasses.fields(FilterState))

# a pytree node, so a step that takes and returns states can be captured
# and replayed as a CUDA graph (`graphs.graphed`) like any tuple of tensors
register_pytree_node(
    FilterState,
    lambda s: ([getattr(s, n) for n in FIELDS], None),
    lambda leaves, _: FilterState(*leaves),
    serialized_type_name="uvio_tpu_torch.types.state.FilterState",
)


def _field_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    if name in _F64_FIELDS:
        return torch.float64
    if name in _BOOL_FIELDS:
        return torch.bool
    if name in _INT_FIELDS:
        return torch.int64
    return dtype


def init_state(layout: StateLayout, dtype=torch.float64, device=None) -> FilterState:
    """Identity-orientation zero state with zero covariance.

    `dtype` sets the compute precision of every block except the time
    axis (`time`, `clones_t`), which is always f64: epoch-second
    timestamps have only ~128 s resolution in f32. `device=None` is
    `default_device()`: the card, or an error without one.
    """
    K, S, A, C = layout.max_clones, layout.max_slam, layout.max_anchors, layout.num_cams
    q0 = np.array([0.0, 0.0, 0.0, 1.0])
    arrays = {
        "time": np.array(-1.0),
        "q": q0, "p": np.zeros(3), "v": np.zeros(3),
        "bg": np.zeros(3), "ba": np.zeros(3),
        "q_fej": q0, "p_fej": np.zeros(3), "v_fej": np.zeros(3),
        "clones_q": np.tile(q0, (K, 1)), "clones_p": np.zeros((K, 3)),
        "clones_q_fej": np.tile(q0, (K, 1)), "clones_p_fej": np.zeros((K, 3)),
        "clones_t": np.full((K,), -1.0),
        "clones_valid": np.zeros((K,), bool),
        "clone_head": np.array(-1),
        "slam_p": np.zeros((S, 3)), "slam_p_fej": np.zeros((S, 3)),
        "slam_valid": np.zeros((S,), bool),
        "slam_id": np.full((S,), -1),
        "slam_anchor_slot": np.zeros((S,), int),
        "slam_anchor_cam": np.zeros((S,), int),
        "calib_imu_dw": np.asarray(dm_identity(layout.imu_model)),
        "calib_imu_da": np.asarray(dm_identity(layout.imu_model)),
        "calib_imu_tg": np.zeros(9),
        "calib_imu_gq": q0, "calib_imu_aq": q0,
        "calib_dt": np.array(0.0),
        "calib_cam_q": np.tile(q0, (C, 1)),
        "calib_cam_p": np.zeros((C, 3)),
        "calib_cam_intr": np.concatenate([np.ones((C, 2)), np.zeros((C, 6))], axis=1),
        "uwb_p_IinU": np.zeros(3),
        "anchors_p": np.zeros((A, 3)),
        "anchors_gamma": np.zeros((A,)), "anchors_alpha": np.zeros((A,)),
        "anchors_valid": np.zeros((A,), bool),
        "cov": np.zeros((layout.dim, layout.dim)),
    }
    return state_from_numpy(arrays, device, dtype)


def num_clones(state: FilterState) -> torch.Tensor:
    return state.clones_valid.sum()


def oldest_clone_slot(state: FilterState, layout: StateLayout) -> torch.Tensor:
    """Slot of the oldest valid clone (ring order: head+1 when full)."""
    inf = torch.full_like(state.clones_t, float("inf"))
    return torch.argmin(torch.where(state.clones_valid, state.clones_t, inf))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0 for an index tensor of any shape (a slot), without
    the host read that indexing with a 0-d tensor does. Indices must be
    valid: unlike `lax.dynamic_slice`, nothing clamps them."""
    return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def where_state(pred: torch.Tensor, a: FilterState, b: FilterState) -> FilterState:
    """Field-wise `torch.where(pred, a, b)`: the device-side select that
    stands in for `lax.cond` on a state (both branches were computed)."""
    return FilterState(
        **{name: torch.where(pred, getattr(a, name), getattr(b, name)) for name in FIELDS}
    )


def state_from_numpy(arrays, device=None, dtype=torch.float64) -> FilterState:
    """Build a state from numpy arrays keyed by field name (e.g. the
    fields of a `uvio_tpu` FilterState passed through `np.asarray`), on
    `device` (None: `default_device()`)."""
    device = resolve_device(device)
    return FilterState(
        **{
            name: torch.as_tensor(
                np.array(arrays[name]), dtype=_field_dtype(name, dtype), device=device
            )
            for name in FIELDS
        }
    )


def state_to_numpy(state: FilterState) -> dict:
    """Numpy arrays keyed by field name; integer fields come back as
    int32 and everything else in its tensor's dtype."""
    out = {}
    for name in FIELDS:
        a = getattr(state, name).detach().cpu().numpy()
        out[name] = a.astype(np.int32) if name in _INT_FIELDS else a
    return out


def carry_from_numpy(carry, device=None):
    """Fused-step track carry `(pyramid list, uv, active, hist_uv,
    hist_mask)` from numpy arrays, on `device` (None: `default_device()`)."""
    device = resolve_device(device)
    pyr, uv, active, hist_uv, hist_mask = carry
    f32 = torch.float32
    return (
        [torch.as_tensor(np.array(lev), dtype=f32, device=device) for lev in pyr],
        torch.as_tensor(np.array(uv), dtype=f32, device=device),
        torch.as_tensor(np.array(active), dtype=torch.bool, device=device),
        torch.as_tensor(np.array(hist_uv), dtype=f32, device=device),
        torch.as_tensor(np.array(hist_mask), dtype=torch.bool, device=device),
    )


def carry_to_numpy(carry):
    pyr, uv, active, hist_uv, hist_mask = carry
    to_np = lambda t: t.detach().cpu().numpy()
    return ([to_np(lev) for lev in pyr], to_np(uv), to_np(active), to_np(hist_uv), to_np(hist_mask))

"""Filter-state checkpoint / resume.

Port of `uvio_tpu/utils/checkpoint.py`, writing and reading the same npz
layout: one `state/<field>` array per `FilterState` field plus `__meta__`,
the host bookkeeping as JSON bytes. The layout is what carries an
estimator across packages: a checkpoint that `uvio_tpu` wrote loads here,
and one written here loads there.
"""

from __future__ import annotations

import json

import numpy as np

from ..types.state import FIELDS, FilterState, state_from_numpy, state_to_numpy


def save_state(path: str, state: FilterState, host_meta: dict) -> None:
    """Write a FilterState + host bookkeeping to one .npz."""
    flat = {f"state/{k}": v for k, v in state_to_numpy(state).items()}
    flat["__meta__"] = np.frombuffer(json.dumps(host_meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_state(path: str, template: FilterState):
    """Read back (FilterState, host_meta). `template` supplies the device
    and the compute dtype (build it with the same config); a file whose
    arrays do not have the template's shapes is refused."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        arrays = {k: z[f"state/{k}"] for k in FIELDS}
    for k, a in arrays.items():
        if a.shape != tuple(getattr(template, k).shape):
            raise ValueError(
                f"checkpoint field {k} has shape {a.shape}, this layout needs "
                f"{tuple(getattr(template, k).shape)}"
            )
    return state_from_numpy(arrays, template.cov.device, template.cov.dtype), meta

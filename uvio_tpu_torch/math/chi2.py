"""Chi-squared 95% gating table.

The reference builds `boost::math::chi_squared` quantiles on the fly
(`UpdaterMSCKF.cpp:47-55`); the table here is computed once at import
with scipy, and the gate is a plain gather into it.
"""

import functools

import numpy as np
import torch
from scipy import stats

MAX_DOF = 1024

_table = stats.chi2.ppf(0.95, np.arange(1, MAX_DOF + 1))
# dof index 0 unused; lookups are clamped into [1, MAX_DOF]
CHI2_95 = np.concatenate([[_table[0]], _table])


@functools.lru_cache(maxsize=8)
def _device_table(device: torch.device) -> torch.Tensor:
    # one host->device copy per device, at the first lookup there
    return torch.as_tensor(CHI2_95, dtype=torch.float64, device=device)


def chi2_95(dof: torch.Tensor, max_dof: int = 0) -> torch.Tensor:
    """95% chi2 quantile for an integer dof tensor.

    With `max_dof` (a static bound, e.g. the padded row count) the dof
    saturates at the largest quantile of that bound, as in `uvio_tpu`:
    an out-of-range dof must not gate at threshold 0.
    """
    hi = max_dof if max_dof and max_dof < MAX_DOF else MAX_DOF
    return _device_table(dof.device)[torch.clamp(dof, 1, hi).long()]

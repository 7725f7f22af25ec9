"""Port parity of the live managers, frame by frame (the checks of
`test_torch_live_configs.py`), with online IMU-intrinsic calibration and
g-sensitivity, identity-seeded on the miscalibrated simulator of
`tests/test_imu_intrinsics.py:118-125` (plus a g-sensitivity), under both
IMU models: kalibr with SLAM in representation 5, and rpng. `calib_imu_dw`,
`_da`, `_tg` and the IMU-frame rotations are compared at every frame with
the rest of the state (1e-8).
"""

import numpy as np
import torch

from test_torch_live_configs import SLAM, assert_slam_exercised, live_run

from uvio_tpu_torch.types.state import dm_identity

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False  # the step insists on full-float32 products

TRUE_DW = np.array([1.02, 0.004, -0.003, 0.985, 0.006, 1.01])  # kalibr: lower triangle, column-wise
TRUE_DA = np.array([0.99, -0.005, 0.004, 1.015, -0.006, 0.98])
TRUE_TG = np.array([0.002, -0.001, 0.0, 0.001, 0.003, -0.002, 0.0, 0.001, -0.001])
CALIB = dict(calib_imu_intrinsics=True, calib_imu_g_sensitivity=True, calib_imu_dw_prior=0.03,
             calib_imu_da_prior=0.03)


def _moved(pair, model):
    st = pair.t.state
    for v in (st.calib_imu_dw, st.calib_imu_da):
        assert not np.allclose(v.numpy(), dm_identity(model))
    assert np.abs(st.calib_imu_tg.numpy()).max() > 0


def test_rep5_with_imu_intrinsics_kalibr():
    params = dict(imu_model=0, imu_dw=TRUE_DW, imu_da=TRUE_DA, imu_tg=TRUE_TG)
    pair, counts = live_run(14, 4, dict(SLAM, feat_rep_slam=5, imu_model=0, **CALIB), params=params)
    assert pair.t.layout.imu_intr_dim == 24
    _moved(pair, 0)
    assert_slam_exercised(pair, counts, 5)


def test_imu_intrinsics_rpng():
    # rpng fills the upper triangle column-wise: the same matrices as above, transposed
    up = [0, 1, 3, 2, 4, 5]
    params = dict(imu_model=1, imu_dw=TRUE_DW[up], imu_da=TRUE_DA[up], imu_tg=TRUE_TG)
    pair, _ = live_run(14, 4, dict(imu_model=1, **CALIB), params=params)
    assert pair.t.layout.imu_intr_dim == 24 and pair.t.layout.imu_model == 1
    _moved(pair, 1)

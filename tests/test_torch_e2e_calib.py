"""The port's twins of the other slow end-to-end regressions of
`uvio_tpu`: IMU-intrinsic calibration (`tests/test_imu_intrinsics.py:93`,
`:113`), the discrete and analytical integrators in a live manager
(`tests/test_integration_methods.py:144`) and the UWB run
(`tests/test_uwb.py:327`). Same scenarios, seeds and gates, on the device
of the `device` fixture (the CPU here; `tests/test_torch_e2e_cuda.py` runs
them on the card); the scenarios are in `tests/torch_e2e_scenarios.py`. Slow: run
them with

    OMP_NUM_THREADS=1 python -m pytest -m slow -p xdist -n 4 tests/test_torch_e2e_calib.py
"""

import pytest
import torch

import torch_e2e_scenarios as S

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False  # the step insists on full-float32 products

pytestmark = pytest.mark.slow


@pytest.fixture
def device():
    return "cpu"


def test_seeded_true_intrinsics_track(device):
    S.run("imu_seeded", device)


def test_wrong_intrinsics_hurt_then_calibration_recovers(device):
    S.run("imu_calibrated", device)


@pytest.mark.parametrize("method", ["discrete", "analytical"])
def test_sim_tracks_all_methods(device, method):
    S.run(f"integration_{method}", device)


def test_uwb_e2e_ate(device):
    S.run("uwb", device)

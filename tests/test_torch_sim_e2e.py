"""The port's twins of `tests/test_sim_e2e.py`'s end-to-end regressions:
the same simulators, seeds, horizons and gates, with `uvio_tpu_torch`'s
`VioManager` on the device of the `device` fixture (the CPU here;
`tests/test_torch_e2e_cuda.py` runs them on the card). The scenarios are in
`tests/torch_e2e_scenarios.py`. Slow: run them with

    OMP_NUM_THREADS=1 python -m pytest -m slow -p xdist -n 4 tests/test_torch_sim_e2e.py
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


def test_msckf_sim_bounded_error(device):
    S.run("msckf", device)


def test_slam_improves_accuracy(device):
    S.run("slam_vs_msckf", device)


def test_stereo_beats_mono(device):
    S.run("stereo", device)


@pytest.mark.parametrize("rep", [0, 1, 2, 3, 4, 5])
def test_slam_representations(device, rep):
    S.run(f"rep{rep}", device)


def test_camimu_time_offset_applied_and_converges(device):
    S.run("time_offset", device)


def test_online_extrinsic_calibration(device):
    S.run("extrinsic", device)

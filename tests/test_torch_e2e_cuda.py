"""The sixteen end-to-end twins of `tests/test_torch_sim_e2e.py` and
`tests/test_torch_e2e_calib.py` on the card: the same scenario code
(`tests/torch_e2e_scenarios.py`) and gates, every manager on `cuda:0` in
float64. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`; on a machine with only PyTorch, skip
the JAX conftest:

    OMP_NUM_THREADS=1 python -m pytest --noconftest -m cuda tests/test_torch_e2e_cuda.py
"""

import json

import pytest
import torch

import torch_e2e_scenarios as S

pytestmark = [pytest.mark.cuda, pytest.mark.slow]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the scenarios run their managers on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda:0"


@pytest.mark.parametrize("name", list(S.SCENARIOS))
def test_scenario_on_the_card(device, name):
    print(json.dumps({"e2e_cuda": S.run(name, device), "card": torch.cuda.get_device_name(0)}))

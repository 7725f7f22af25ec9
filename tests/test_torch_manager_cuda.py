"""The port's live host loop on the card: the float64 `UVioManager`, fed by
the port's simulator from the first IMU sample, against the committed
fixture that `uvio_tpu` captured. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_manager_cuda.py
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.eval.capture import bench_scenario, record_live
from uvio_tpu_torch.fixtures import load_full_step_fixture
from uvio_tpu_torch.pipeline import FrameBundle
from uvio_tpu_torch.types.state import FIELDS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the live loop's default device is the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def test_live_float64_loop_matches_fixture(dev):
    """20 warm-up frames and the first 5 captured ones (25 frames live):
    the state after the warm-up is the fixture's `state0` and each bundle
    the fixture's: masks and indices exactly, floats to 1e-9."""
    fx = load_full_step_fixture()
    # the fixture's simulator: its map depends on the trajectory's length, 120 frames
    sim, mgr = bench_scenario(120, seed=7, max_slam=25, dtype="float64")
    assert mgr.state.cov.device == dev
    rec = record_live(sim, mgr, 25, snapshot_at=20)
    state0, bundles = rec["snapshot"], rec["bundles"][20:]

    def check(got, ref, names, what):
        for name in names:
            a, b = np.asarray(got[name]), ref[name]
            if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=f"{what} {name}")

    check(state0, fx.state0, FIELDS, "state0")
    assert len(bundles) == 5
    for k, b in enumerate(bundles):
        check(b, fx.bundles[k], FrameBundle._fields, f"bundle {k}")

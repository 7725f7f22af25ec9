"""The port's live host loop on the card: the float64 `UVioManager`, fed by
the port's simulator from the first IMU sample, against the committed
fixture that `uvio_tpu` captured; `_marginalize` with no host sync; and
`HostPipeline`'s side-stream staging. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_manager_cuda.py
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.eval.capture import bench_scenario, drive, record_live
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


def test_marginalize_passes_the_slot_without_a_sync(dev):
    """The clone slot reaches `anchor_change` and `marginalize_clone` as a
    Python int: `_marginalize` (with 25 SLAM slots, anchored landmarks)
    runs under `set_sync_debug_mode("error")`."""
    sim, mgr = bench_scenario(120, seed=7, max_slam=25, dtype="float64")
    drive(sim, mgr, 25)
    t_cam = None
    while t_cam is None:  # the IMU up to the next camera frame
        t, w, a = sim.get_next_imu()
        mgr.feed_imu(t, w, a)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            t_cam = sim.get_next_cam()[0]
    mgr._propagate_clone(t_cam)  # uploads its IMU window: not under test
    K = mgr.cfg.max_clones
    assert len(mgr.slot_times) == K + 1 and int(mgr.state.slam_valid.sum()) > 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mgr._marginalize(t_cam)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(mgr.slot_times) == K and int(mgr.state.clones_valid.sum()) == K


def test_host_pipeline_stages_on_a_side_stream(dev):
    """Chunks staged from pinned memory on the pipeline's side stream are
    complete when the consumer's stream uses them right away."""
    from uvio_tpu_torch.pipeline import HostPipeline

    n = 1 << 22
    chunks = ({"x": np.full((n,), i, np.float32), "ids": np.arange(i, i + 5)} for i in range(6))
    pipe = HostPipeline(chunks)  # device None: the card
    assert pipe._stream is not None and pipe._stream != torch.cuda.current_stream()
    got = 0
    for i, c in enumerate(pipe):
        assert c["x"].device == dev and c["ids"].device == dev
        total = c["x"].double().sum()  # queued at once on the consumer's stream
        assert float(total) == float(i) * n
        np.testing.assert_array_equal(c["ids"].cpu().numpy(), np.arange(i, i + 5))
        got += 1
    assert got == 6

"""The batched full filter step on the card: a batch of the committed
fixture's four sequences (`fixtures/batched_seeds.npz`) through
`make_batched_full_step` on cuda:0 against four single steps, one per
sequence, on the same card, float64. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_batched_cuda.py

Tolerances: the same float64 arithmetic, batched and not: every info
equal, states within 1e-9 after 10 frames.
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.fixtures import load_batched_fixture
from uvio_tpu_torch.pipeline import (
    FullStepConfig,
    bundle_from_numpy,
    make_batched_full_step,
    make_full_step,
    plan_batch,
    plan_frame,
    stack_bundles,
)
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy

pytestmark = pytest.mark.cuda
INFO_KEYS = ("slam_kept", "slam_failed", "slam_inited", "uwb_accepted", "cov_ok", "zupt_accepted")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def test_batch_of_four_equals_four_single_steps(dev):
    fx = load_batched_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    bstep, sstep = make_batched_full_step(cfg), make_full_step(cfg)
    B = len(fx.seeds)
    batch = state_from_numpy(fx.state0, dev)
    singles = [state_from_numpy({k: v[b] for k, v in fx.state0.items()}, dev) for b in range(B)]
    times = [float(t) for t in fx.state0["time"]]
    for k, frame in enumerate(fx.bundles[:10]):
        batch, bi = bstep(batch, *stack_bundles(frame, plan_batch(frame, times), dev))
        for b in range(B):
            singles[b], si = sstep(singles[b], bundle_from_numpy(frame[b], dev), plan_frame(frame[b], times[b]))
            for key in INFO_KEYS:
                assert torch.equal(bi[key][b], si[key]), (k, b, key)
            for key in ("num_used", "kept", "tri_ok", "cov_ok"):
                assert torch.equal(bi["msckf"][key][b], si["msckf"][key]), (k, b, key)
            for n in FIELDS:
                x, y = getattr(batch, n)[b], getattr(singles[b], n)
                if x.dtype.is_floating_point:
                    assert float((x - y).abs().max()) <= 1e-9, (k, b, n)
                else:
                    assert torch.equal(x, y), (k, b, n)
        times = [float(b["stamp_time"]) for b in frame]
    assert batch.p.device == dev and np.ptp(batch.p[:, 0].cpu().numpy()) > 1e-3

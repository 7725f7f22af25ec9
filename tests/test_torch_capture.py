"""Port parity, `eval.capture.capture_sim_bundles`: the live host loop of
both packages on `bench.py`'s scenario (seed 7, 4 biased UWB anchors,
12 clone slots, 40 MSCKF features and 4 range sets a frame), float64 on
the CPU. Every captured bundle must carry the same masks and indices
and the same floats to 1e-9 (the simulators agree to 1e-9 and the states
that choose the IMU windows to 1e-8), the warm-up state agrees to 1e-8,
and the step configurations are equal field for field."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_manager import assert_bundles_equal

from uvio_tpu.eval.capture import capture_sim_bundles as j_capture

from uvio_tpu_torch.eval.capture import capture_sim_bundles as t_capture
from uvio_tpu_torch.types.state import FIELDS

torch.set_num_threads(1)


def _compare(max_slam):
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(n_warm=3, n_bench=5, seed=7, max_slam=max_slam, dtype="float64")
    jcfg, jstate, jbundles = j_capture(**kw)
    tcfg, tstate, tbundles = t_capture(device="cpu", **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert len(tbundles) == len(jbundles) == 5
    for k, (tb, jb) in enumerate(zip(tbundles, jbundles)):
        assert_bundles_equal(tb, jb, k)
    for n in FIELDS:
        b = np.asarray(getattr(jstate, n))
        if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(tstate[n], b, err_msg=n)
        else:
            np.testing.assert_allclose(tstate[n], b, rtol=0, atol=1e-8, err_msg=n)
    assert any(b["uwb_mask"].any() for b in tbundles) and any(b["msckf_mask"].any() for b in tbundles)


def test_capture_matches_small_slam():
    _compare(max_slam=8)


@pytest.mark.slow
def test_capture_matches_bench_width():
    _compare(max_slam=25)

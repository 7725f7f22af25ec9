"""The dataset entry point (`utils/euroc.py`): the port's `EurocDataset`
reads `tests/test_euroc_reader.py`'s fixture exactly as `uvio_tpu`'s
does; `run_euroc` (config directory + ASL dataset -> `KLTTracker` ->
self-initialising manager -> TUM file) runs on the CPU on a synthetic
dataset that `write_synthetic_dataset` renders from the port's
simulator, as `uvio_tpu`'s regression renders it, under that
regression's gates (>= 25 poses, posyaw ATE < 0.5 m): a 5 s sequence
here, the regression's own 16 s one in the slow twin."""

import os

import numpy as np
import pytest
import torch

from uvio_tpu.utils.euroc import EurocDataset as JDataset

from uvio_tpu_torch.eval import ate
from uvio_tpu_torch.eval.traj import load_tum
from uvio_tpu_torch.utils.euroc import EurocDataset, run_euroc, write_synthetic_dataset

from test_euroc_reader import make_fixture

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False  # the managers insist on full-float32 products
torch.backends.cuda.matmul.allow_tf32 = False

MONO_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "data", "streams", "mono", "config")


def test_reader_matches(tmp_path):
    root = make_fixture(tmp_path)
    j, t = JDataset(root), EurocDataset(root)
    for (ta, wa, aa), (tb, wb, ab) in zip(j.imu(), t.imu(), strict=True):
        assert ta == tb
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(aa, ab)
    assert list(j.images("cam0")) == list(t.images("cam0"))
    jg, tg = j.groundtruth(), t.groundtruth()
    for k in jg:
        np.testing.assert_array_equal(tg[k], jg[k])
    np.testing.assert_allclose(tg["q_GtoI"][0], [-0.15, -0.82, -0.16, 0.53])


def _run(tmp_path, **scene):
    root, cfg = write_synthetic_dataset(str(tmp_path), MONO_CONFIG, **scene)
    out = tmp_path / "est.txt"
    t, q, p = run_euroc(root, cfg, out_path=str(out), device="cpu")
    assert len(t) >= 25, len(t)
    tt, qq, pp = load_tum(str(out))
    np.testing.assert_allclose(tt, t)
    gt = EurocDataset(root).groundtruth()
    res = ate(t, q, p, gt["t"], gt["q_GtoI"], gt["p"], method="posyaw")
    assert res["rmse_pos"] < 0.5, res["rmse_pos"]
    return t, res


def test_run_euroc_short_sequence(tmp_path):
    t, _ = _run(tmp_path, duration=5.0, still_time=2.5)
    assert len(t) >= 25  # static init fires after the 2 s window at rest


@pytest.mark.slow
def test_run_euroc_on_synthetic_dataset_port(tmp_path):
    """`tests/test_euroc_reader.py::test_run_euroc_on_synthetic_dataset`
    through the port: seed 13, 16 s with 5 s at rest, 90 points."""
    _run(tmp_path, seed=13, duration=16.0, still_time=5.0, num_pts=90)

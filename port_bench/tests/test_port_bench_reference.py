"""The plain reference on its own: its range Jacobian against the range
model, its filter against the simulator's truth, and the settings it
refuses. (Its agreement with the port is `test_port_bench_check.py`'s.)"""

import copy
import dataclasses
import os

import numpy as np
import pytest

from port_bench import check
from port_bench.harness import BENCH_DIR, cell_files
from port_bench.reference import config as ref_config
from port_bench.reference.uvio import UVio
from port_bench.traffic.generate import make_traffic

CORRIDOR = os.path.join(BENCH_DIR, "configs", "uvio_corridor_sim")


def test_range_jacobian_matches_the_range_model():
    est = UVio(ref_config.load(CORRIDOR))
    rng = np.random.default_rng(4)
    q = rng.standard_normal(4)
    est.initialize_with_gt(0.0, q / np.linalg.norm(q) * np.sign(q[3]), [1.0, -2.0, 0.5], np.zeros(3),
                           np.zeros(3), np.zeros(3))
    est.lever = np.array([0.05, -0.02, 0.1])
    est.alpha[:] = [0.01, -0.02, 0.03, 0.0]
    for i in range(len(est.anchors_p)):
        y0, H = est._range(i)
        for j in range(len(est.cov)):
            moved = copy.deepcopy(est)
            dx = np.zeros(len(est.cov))
            dx[j] = 1e-6
            moved._inject(dx)
            assert (moved._range(i)[0] - y0) / 1e-6 == pytest.approx(H[j], abs=2e-6)


def test_the_reference_follows_the_truth():
    """Over 14 s of the corridor the reference's pose stays within a few
    centimetres of the simulator's truth, and its covariance stays
    positive semi-definite (the newest clone copies the IMU's pose, so it
    is singular to round-off)."""
    _, config, mix = cell_files("uwb_corridor.live")
    tr = make_traffic(config, dict(mix, warmup_s=4.0), 31, 10.0, BENCH_DIR)
    out = check.reference_outputs(config, tr, BENCH_DIR, 140)
    truth = tr.sim.state(tr.stream.cam_t[:140])["p_IinG"].numpy()
    err = np.linalg.norm(out.rows[:, 4:7] - truth, axis=1)
    assert err.max() < 0.1 and err[-20:].mean() < 0.05
    cov = out.final["cov"]
    assert np.diag(cov).min() > 0.0 and np.linalg.eigvalsh(cov).min() > -1e-12 * np.abs(cov).max()
    # the anchors' estimates moved from their priors toward the truth
    est = ref_config.load(CORRIDOR)
    prior = np.array([a.p_AinG for a in est.anchors])
    true = np.array([v[:3] for v in config["sim"]["anchors"].values()])
    assert np.linalg.norm(out.final["anchors_p"] - true) < np.linalg.norm(prior - true)


@pytest.mark.parametrize("key,value", [("max_slam", 50), ("calib_cam_intrinsics", True), ("integration", "discrete"),
                                       ("try_zupt", True)])
def test_unsupported_settings_are_refused(key, value):
    cfg = ref_config.load(CORRIDOR)
    cfg = dataclasses.replace(cfg, raw=dict(cfg.raw, **{key: value}))
    assert key in cfg.supported()
    with pytest.raises(NotImplementedError):
        UVio(cfg)

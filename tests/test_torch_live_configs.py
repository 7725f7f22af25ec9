"""Port parity of the live managers in the estimator configurations of
`uvio_tpu`'s end-to-end regressions, frame by frame: `uvio_tpu`'s
`VioManager` and the port's, float64 on the CPU, fed the same simulator
stream through `make_pair` (`tests/test_torch_manager.py`).

At every frame: the bundles' masks and indices equal and their floats to
1e-9, every decision info of the fused step equal (MSCKF and SLAM kept,
failed and initialized, cov_ok), the SLAM slot table and host mirrors
equal, and the whole state (calibration states included) to 1e-8. Each
run folds several configurations into one (the JAX compiles dominate a
run's time) and runs SLAM in one representation other than the default
(held by `test_slam_run_matches`); an anchored representation must
re-anchor a landmark inside the run. This file: representation 0 with the
discrete integrator, representation 2 with the analytical one; siblings
`test_torch_live_calib.py` and `test_torch_live_imu.py` hold the rest.
"""

import numpy as np
import torch

from test_torch_manager import make_pair, sim_events
from test_torch_pipeline import _assert_infos_equal

from uvio_tpu_torch.update.representations import is_anchored

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False  # the step insists on full-float32 products

SLAM = dict(max_slam=8, dt_slam_delay=0.4, max_slam_init_per_frame=4)


def live_run(n_frames, seed, cfg, params=None, traj=None, t_shift=0.0, jextra=None, textra=None):
    """`n_frames` of one simulator run through both managers, checked at
    every frame; frames reach the managers stamped `t - t_shift` (the
    camera clock). Returns (pair, SLAM counts): frames with a landmark
    initialized, re-observed and kept, and landmarks re-anchored."""
    sim, events = sim_events(n_frames, seed=seed, params=params, **(traj or {}))
    events = [("cam", ev[1] - t_shift, ev[2]) if ev[0] == "cam" else ev for ev in events]
    pair = make_pair(sim, jextra=jextra, textra=textra, **cfg)
    g = sim.get_gt_state(sim.t_start)
    for m in (pair.j, pair.t):
        m.initialize_with_gt(sim.t_start - t_shift, g["q_GtoI"], g["p_IinG"], g["v_IinG"], g["bg"], g["ba"])
    counts = dict(inited=0, kept=0, reanchored=0)
    before = None
    for ev in events:
        pair.feed(ev)
        if ev[0] != "cam":
            continue
        k = len(pair.ti) - 1
        _assert_infos_equal(pair.ji[k], pair.ti[k], k)
        info = pair.ti[k]
        counts["inited"] += bool(info["slam_inited"].any())
        counts["kept"] += bool(info["slam_kept"].any())
        st = pair.t.state
        now = (st.slam_valid.numpy().copy(), st.slam_id.numpy().copy(), st.slam_anchor_slot.numpy().copy())
        if before is not None:  # the same landmark in the same slot, on another anchor clone
            same = before[0] & now[0] & (before[1] == now[1])
            counts["reanchored"] += int((same & (before[2] != now[2])).sum())
        before = now
    assert pair.checked == n_frames == len(pair.ti)
    return pair, counts


def assert_slam_exercised(pair, counts, rep):
    """Landmarks were initialized, re-observed (and kept) and, in an
    anchored representation, re-anchored; a global one never moves its
    anchor."""
    assert pair.t.layout.slam_rep == rep
    assert counts["inited"] >= 1 and counts["kept"] >= 1, counts
    assert sum(b["slam_mask"].any() for b in pair.tb) >= 3
    if is_anchored(rep):
        assert counts["reanchored"] >= 1, counts
    else:
        assert counts["reanchored"] == 0, counts


def test_rep0_with_discrete_integration():
    # a global 3-D point needs a tenth of the depth/baseline ratio that the
    # other representations accept (`update/slam.py`): the full 11-clone
    # window gives it that baseline, from frame 12 on
    pair, counts = live_run(16, 4, dict(SLAM, feat_rep_slam=0, integration="discrete", max_clones=11))
    assert pair.t.integration == pair.j.cfg.integration == "discrete"
    assert_slam_exercised(pair, counts, 0)


def test_rep2_with_analytical_integration():
    pair, counts = live_run(14, 4, dict(SLAM, feat_rep_slam=2, integration="analytical"))
    assert pair.t.integration == "analytical"
    assert_slam_exercised(pair, counts, 2)

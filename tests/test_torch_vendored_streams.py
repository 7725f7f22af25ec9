"""The vendored recorded streams (`data/streams/{mono,stereo,uwb}`) through
the port's managers, each built by the port's `load_config` from the
stream's own config directory.

Tier-1: the first 50 frames of the mono stream (`VioManager`) and of the
UWB stream (`UVioManager`, range updates and anchor calibration) through
`uvio_tpu`'s and the port's managers, float64, fed event by event: every
bundle, the state (1e-8) and the host mirrors equal after every frame
(`test_torch_manager.Pair`).

Slow: the three full replays through the port alone, under the gates of
`uvio_tpu`'s regression (`tests/test_vendored_streams.py`), which hold it
to the C++ reference's own output on the same streams: SE(3) ATE
<= 1.2x `ref_est.txt`'s for mono and stereo, <= 1x for UWB, and the final
anchor error <= `anchors_est.txt`'s.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from uvio_tpu.manager import VioManager as JVioManager
from uvio_tpu.utils import load_config as j_load
from uvio_tpu.uwb_manager import UVioManager as JUVioManager

from uvio_tpu_torch.eval import ate, load_tum
from uvio_tpu_torch.manager import VioManager
from uvio_tpu_torch.utils import load_config
from uvio_tpu_torch.utils.streams import anchor_errors, replay, stream_events
from uvio_tpu_torch.uwb_manager import UVioManager

from test_torch_manager import Pair

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False  # the step insists on full-float32 products

STREAMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "streams")
NO_INIT = dict(use_static_init=False, use_dynamic_init=False)  # seeded from init.txt


@pytest.mark.parametrize("stream", ["mono", "uwb"])
def test_first_frames_match_uvio_tpu(stream):
    data = os.path.join(STREAMS, stream)
    jcfg, _ = j_load(os.path.join(data, "config"))
    tcfg, _ = load_config(os.path.join(data, "config"), device="cpu")
    jcls, tcls = (JUVioManager, UVioManager) if stream == "uwb" else (JVioManager, VioManager)
    pair = Pair(jcls(dataclasses.replace(jcfg, **NO_INIT)), tcls(dataclasses.replace(tcfg, **NO_INIT)))
    init, events = stream_events(data, len(tcfg.cameras), tcfg.camimu_dt, uwb=stream == "uwb")
    for m in (pair.j, pair.t):
        m.initialize_with_gt(init[0], init[1:5], init[5:8], init[8:11], init[11:14], init[14:17])
    frames = 0
    for ev in events:
        pair.feed(ev)
        frames += ev[0] == "cam"
        if frames == 50:
            break
    assert pair.checked == 50
    assert sum(b["msckf_mask"].any() for b in pair.tb) >= 40
    if stream == "uwb":
        assert pair.t.anchor_slot_by_id == pair.j.anchor_slot_by_id and len(pair.t.anchor_slot_by_id) == 4
        assert sum(int(np.asarray(b["uwb_mask"]).sum()) for b in pair.tb) > 0  # ranges were drained


def _gates(data, t, q, p, slack):
    assert len(t) > 400
    tg, qg, pg = load_tum(os.path.join(data, "gt.txt"))
    ours = ate(t, q, p, tg, qg, pg, method="se3")
    ref = ate(*load_tum(os.path.join(data, "ref_est.txt")), tg, qg, pg, method="se3")
    assert ours["rmse_pos"] <= slack * ref["rmse_pos"], (ours, ref)
    return ours, ref


@pytest.mark.slow
@pytest.mark.parametrize("stream", ["mono", "stereo", "uwb"])
def test_full_replay_against_the_cpp_reference(stream):
    data = os.path.join(STREAMS, stream)
    cfg, _ = load_config(os.path.join(data, "config"), device="cpu")
    mgr = (UVioManager if stream == "uwb" else VioManager)(dataclasses.replace(cfg, **NO_INIT))
    t, q, p = replay(mgr, data)
    ours, ref = _gates(data, t, q, p, 1.0 if stream == "uwb" else 1.2)
    if stream == "uwb":
        err, ref_err = anchor_errors(mgr, data)
        assert err <= ref_err, (err, ref_err)
    else:
        assert ours["rmse_ori_deg"] <= 1.2 * ref["rmse_ori_deg"], (ours, ref)

"""Port parity, checkpoints: `uvio_tpu_torch.utils.checkpoint` writes and
reads `uvio_tpu`'s npz layout (`state/<field>` arrays plus `__meta__` as
JSON bytes), so an estimator crosses between the packages. float64 on the
CPU; a restored state is bit-equal to the saved one, and managers that
swapped checkpoints stay within 1e-8 of each other on every later frame."""

import json

import numpy as np
import torch

from test_torch_manager import TCam, SMALL, init_at_start, make_pair, sim_cameras, sim_events

from uvio_tpu_torch.manager import VioConfig, VioManager
from uvio_tpu_torch.types.state import FIELDS, state_to_numpy

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

CFG = dict(max_slam=4, dt_slam_delay=0.3, max_slam_init_per_frame=2)


def _split(events, n_frames):
    """Events up to and including camera frame `n_frames`, and the rest."""
    cams = [i for i, ev in enumerate(events) if ev[0] == "cam"]
    cut = cams[n_frames - 1] + 1
    return events[:cut], events[cut:]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """After 10 frames each manager saves; the port's manager loads the JAX
    manager's file and the JAX manager the port's; 5 more frames through
    both stay equal (bundles, state 1e-8, mirrors)."""
    sim, events = sim_events(15, seed=4)
    pair = make_pair(sim, **CFG)
    init_at_start(sim, pair.j, pair.t)
    head, tail = _split(events, 10)
    pair.run(head)
    assert len(pair.t.slam_slot_by_fid) >= 1, "the checkpoint should carry landmarks"
    jfile, tfile = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    pair.j.save_checkpoint(jfile)
    pair.t.save_checkpoint(tfile)
    with np.load(jfile) as zj, np.load(tfile) as zt:
        assert sorted(zj.files) == sorted(zt.files) == sorted([f"state/{n}" for n in FIELDS] + ["__meta__"])
        for k in zj.files:
            if k != "__meta__":
                assert zt[k].shape == zj[k].shape and zt[k].dtype.kind == zj[k].dtype.kind, k
        mj, mt = (json.loads(bytes(z["__meta__"].tobytes()).decode()) for z in (zj, zt))
    assert sorted(mj) == sorted(mt)
    assert mj["slot_times"] == mt["slot_times"] and mj["slam_slot_by_fid"] == mt["slam_slot_by_fid"]
    assert mj["db"].keys() == mt["db"].keys() and mj["imu_t"] == mt["imu_t"]

    before = state_to_numpy(pair.t.state)
    pair.t.load_checkpoint(jfile)
    pair.j.load_checkpoint(tfile)
    after = state_to_numpy(pair.t.state)
    for n in FIELDS:  # what the JAX manager wrote is what the port held, to 1e-8
        np.testing.assert_allclose(after[n], before[n], rtol=0, atol=1e-8, err_msg=n)
    assert pair.t._time_host == float(pair.t.state.time) == head[-1][1]
    pair.check("after the swap")
    pair.run(tail)
    assert pair.checked == 15
    assert any(b["slam_mask"].any() for b in pair.tb[10:])


def test_port_checkpoint_round_trip(tmp_path):
    """save -> load into a fresh manager: the state comes back bit-equal,
    and the restored manager runs on as the one that never stopped."""
    sim, events = sim_events(9, seed=5)
    mk = lambda: VioManager(VioConfig(sigma_pix=sim.params.sigma_pix, cameras=sim_cameras(sim, TCam),
                                      device="cpu", **SMALL))
    a = mk()
    init_at_start(sim, a)
    head, tail = _split(events, 6)
    feed = lambda m, evs: [(m.feed_imu if ev[0] == "imu" else m.feed_features)(*ev[1:]) for ev in evs]
    feed(a, head)
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    b = mk()
    b.load_checkpoint(path)
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for n in FIELDS:
        np.testing.assert_array_equal(sb[n], sa[n], err_msg=n)
        assert sb[n].dtype == sa[n].dtype
    assert b.is_initialized and b.slot_times == a.slot_times and b._head == a._head
    assert b._time_host == a._time_host == float(b.state.time)
    assert b.db.to_dict() == a.db.to_dict()
    feed(a, tail)
    feed(b, tail)
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for n in FIELDS:
        np.testing.assert_array_equal(sb[n], sa[n], err_msg=n)
    assert b._time_host == a._time_host == tail[-1][1]

    other = VioManager(VioConfig(device="cpu", max_clones=7))
    try:
        other.load_checkpoint(path)
    except ValueError as e:
        assert "shape" in str(e)
    else:
        raise AssertionError("a checkpoint of another layout must be refused")

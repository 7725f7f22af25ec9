"""The graphed staged steps on the CPU, against `uvio_tpu`.

On the card the staged stages, the UWB drain, IMU-rate pose output and the
trackers' device steps are each one CUDA graph per input shape
(`graphs.graphed`). Two changes made that possible, and this file holds
both to the reference:

  * a slot reaches `marginalize_clone`, `marginalize_slam` and
    `anchor_change` as a tensor (`uvio_tpu` passes `jnp.int32(slot)`), so
    one graph serves every slot: the state is bitwise the one a Python
    int gives, and within 1e-12 of `uvio_tpu`'s;
  * `DescriptorTracker`'s device step and `KLTTracker.stereo_match`, whose
    table is padded to the tracker's capacity, give `uvio_tpu`'s corners
    and matches exactly (`tests/test_torch_descriptor.py`'s terms) and its
    stereo matches within `tests/test_torch_stereo.py:31`'s tolerance; the
    padded match equals the unpadded call bitwise on the real rows.

The live staged managers against `uvio_tpu`'s are `test_torch_staged.py`;
the bodies' capture safety is `test_torch_graph_safety.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvio_tpu.filter import ekf as jekf
from uvio_tpu.frontend import descriptor as JD
from uvio_tpu.types import StateLayout as JLayout
from uvio_tpu.types.state import FilterState as JState
from uvio_tpu.update import representations as jrep

from uvio_tpu_torch.filter import ekf as tekf
from uvio_tpu_torch.fixtures import load_full_step_fixture
from uvio_tpu_torch.frontend import descriptor as TD
from uvio_tpu_torch.types import StateLayout as TLayout
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import representations as trep

torch.set_num_threads(1)

INTR = np.array([195.0, 195.0, 156.0, 124.0, 0, 0, 0, 0])


@pytest.fixture(scope="module")
def snap():
    """The full-step fixture's state after frame 16: 25 landmarks anchored
    at eleven clone slots, clone head 11. (JAX layout, JAX state, port
    layout, port state.)"""
    fx = load_full_step_fixture()
    arrays = fx.snapshots[16]
    lay = fx.config["layout"]
    js = JState(**{n: jnp.asarray(arrays[n]) for n in FIELDS})
    return JLayout(**lay), js, TLayout(**lay), state_from_numpy(arrays, "cpu", torch.float64)


def _assert_bitwise(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    for n in FIELDS:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def _assert_close_to_jax(ts, js):
    got = state_to_numpy(ts)
    for n in FIELDS:
        ref = np.asarray(getattr(js, n))
        if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(got[n], ref, err_msg=n)
        else:
            scale = max(float(np.abs(ref).max()), 1e-300)
            assert float(np.abs(got[n] - ref).max()) <= 1e-12 * scale, n


CASES = [("marginalize_clone", 10), ("marginalize_clone", 3), ("marginalize_slam", 0),
         ("marginalize_slam", 17), ("anchor_change", 10), ("anchor_change", 4)]


@pytest.mark.parametrize("fn,slot", CASES)
def test_slot_as_tensor(snap, fn, slot):
    """Slot as an int, as an int64 tensor (the managers' pinned host
    tensor), and `uvio_tpu`'s with `jnp.int32(slot)`."""
    jl, js, tl, ts = snap
    if fn == "anchor_change":
        moved = int((state_to_numpy(ts)["slam_anchor_slot"] == slot).sum())
        assert moved >= 1
        call_t = lambda s: trep.anchor_change(ts, tl, s, ts.clone_head)
        ref = jrep.anchor_change(js, jl, jnp.int32(slot), js.clone_head)
    else:
        call_t = lambda s: getattr(tekf, fn)(ts, tl, s)
        ref = getattr(jekf, fn)(js, jl, jnp.int32(slot))
    by_int, by_tensor = call_t(slot), call_t(torch.tensor(slot, dtype=torch.int64))
    _assert_bitwise(by_tensor, by_int)
    _assert_close_to_jax(by_tensor, ref)


def _rendered(n, seed=3):
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cam = SimCamera(width=320, height=240, intrinsics=INTR)
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=seed, cameras=[cam]),
                    trajectory=circle_trajectory(duration=10.0))
    frames = []
    for _ in range(n):
        t, _ = sim.get_next_cam()
        frames.append(sim.render_image(t))
    return cam, frames


def test_descriptor_device_steps_match_jax():
    """`step_first` / `step_match` against `_jit_detect` / `_jit_match` on
    three rendered frames: corners, valid masks and matches exact, with
    `uvio_tpu`'s previous frame forced in before each match, as
    `test_torch_descriptor.py`'s tracker test does."""
    cam, frames = _rendered(3)
    jt = JD.DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8))
    tt = TD.DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8), device="cpu")
    img0 = frames[0].astype(np.float32)
    desc, valid, packed = tt.step_first(torch.as_tensor(img0))
    uv_j, desc_j, valid_j = jt._jit_detect(jnp.asarray(img0))
    np.testing.assert_array_equal(packed[:, :2].numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(packed[:, 2].numpy() != 0, np.asarray(valid_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    matched = 0
    for img in frames[1:]:
        img = img.astype(np.float32)
        p_desc, p_valid = desc_j, valid_j
        uv_j, desc_j, valid_j = jt._jit_detect(jnp.asarray(img))
        m_j = np.asarray(jt._jit_match(p_desc, p_valid, desc_j, valid_j))
        desc, valid, packed = tt.step_match(torch.as_tensor(np.asarray(p_desc).astype(np.int64)),
                                            torch.tensor(np.asarray(p_valid)), torch.as_tensor(img))
        np.testing.assert_array_equal(packed[:, :2].numpy(), np.asarray(uv_j))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
        m_t = packed[:, 3].numpy().astype(np.int64)
        np.testing.assert_array_equal(m_t, m_j)
        # the packed column is `hamming_match` on the step's own descriptors
        ref = TD.hamming_match(torch.as_tensor(np.asarray(p_desc).astype(np.int64)),
                               torch.tensor(np.asarray(p_valid)), desc, valid)
        np.testing.assert_array_equal(m_t, ref.numpy())
        matched += int((m_t >= 0).sum())
    assert matched >= 30


def test_stereo_match_padded():
    """The padded `stereo_match` on 1, 17 and all active tracks: bitwise
    the unpadded eager LK on the real rows, and within 1e-3 px of
    `uvio_tpu`'s `stereo_match` where both keep a match (masks equal on
    >= 99%); one graph key serves every count (the padded table's shape)."""
    from uvio_tpu.frontend.tracker import KLTTracker as JT

    from uvio_tpu_torch.frontend.klt import lk_track
    from uvio_tpu_torch.frontend.tracker import KLTTracker as TT
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cams = [SimCamera(width=320, height=240, intrinsics=INTR),
            SimCamera(width=320, height=240, intrinsics=INTR, p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=cams),
                    trajectory=circle_trajectory(duration=10.0))
    t, _ = sim.get_next_cam()
    left, right = sim.render_image(t, cam_idx=0), sim.render_image(t, cam_idx=1)
    kw = dict(num_features=60, grid=(6, 8), histeq="HISTOGRAM")
    jt, tt = JT(INTR, cams[0].model, **kw), TT(INTR, cams[0].model, device="cpu", **kw)
    jt.feed(t, left)
    tt.feed(t, left)
    uv_all = tt.uv[tt.active]
    assert len(uv_all) >= 30
    shapes = set()
    seen = tt.step_stereo.eager

    def spy(pyr_left, img_d, tab):
        shapes.add(tuple(tab.shape))
        return seen(pyr_left, img_d, tab)

    tt.step_stereo = spy
    for n in (1, 17, len(uv_all)):
        uv, valid = uv_all[:n], np.ones(n, bool)
        uv_t, ok_t = tt.stereo_match(left, right, uv, valid, pyr_left=tt.prev_pyr)
        assert uv_t.shape == (n, 2) and ok_t.shape == (n,)
        _, pyr_r = tt._preprocess(right)
        uv_e, ok_e = lk_track(tt.prev_pyr, pyr_r, torch.as_tensor(uv), torch.as_tensor(valid), half=tt.half)
        np.testing.assert_array_equal(uv_t, uv_e.numpy())
        np.testing.assert_array_equal(ok_t, ok_e.numpy())
        uv_j, ok_j = jt.stereo_match(left, right, uv, valid)
        assert (ok_t == np.asarray(ok_j)).mean() >= 0.99
        both = ok_t & np.asarray(ok_j)
        if both.any():
            assert np.abs(uv_t[both] - np.asarray(uv_j)[both]).max() <= 1e-3
    assert shapes == {(tt.cap, 3)}

"""Capture safety of the port's graphed steps, on the CPU.

On the card `graphs.graphed` captures each step into a CUDA graph. A
capture fails, or a replay silently reuses a stale value, where the step
reads a device value on the host or turns host data into a tensor. Here
the body of every graphed function runs on the CPU under a
`TorchDispatchMode` that records each ATen operation: the full step on
the committed fixture's frames with every `FramePlan` bit on and off
(ZUPT in both of its forms), the packed-bundle step of the managers, the
MSCKF-only step, the batched full and MSCKF-only steps on a small batch,
the fused image->pose step and the KLT tracker's two device steps at
small sizes, the staged managers' stages (`manager._stage`) on the
inputs a live staged `UVioManager` gives them (the ZUPT stage in both
forms), and the descriptor tracker's and the stereo match's device
steps. None of them may run an operation that waits for the device
(`_local_scalar_dense`, `nonzero`, `masked_select`, the `unique` family,
`equal`, `is_nonzero`, indexing with a bool mask), that lifts host data
into a tensor (`lift_fresh`), or `cholesky_solve`, whose batched form on
the card is a MAGMA routine that allocates from the host. As on the
card, each body runs once before it is recorded: that run is the graph's
eager warm-up, which fills the `lru_cache`d device tables.

It also checks the results a replay returns: views of one clone of the
graph's output buffers per dtype (`graphs.Packer`), equal to the eager
results in value, shape and dtype and sharing no memory with the inputs.

What the CPU cannot see, and the card tests
(`tests/test_torch_graphs_cuda.py`) do: a host tensor copied to the card
inside a step (`.to(device)` of pageable memory is a no-op here), the
solver libraries' routines on the card (cuSOLVER and cuBLAS, or a MAGMA
hybrid routine that computes on the host), syncs that an operation's
CUDA implementation makes inside one ATen call, the caching allocator
under capture, and the RANSAC generator's state across replays.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from uvio_tpu_torch.fixtures import load_batched_fixture, load_full_step_fixture, stage_batched_fixture
from uvio_tpu_torch.graphs import Packer
from uvio_tpu_torch.pipeline import (
    FramePlan,
    FullStepConfig,
    StepConfig,
    bundle_from_numpy,
    make_batched_full_step,
    make_batched_step,
    make_full_step,
    make_packed_full_step,
    make_step,
    pack_bundle,
    plan_frame,
)
from uvio_tpu_torch.types import StateLayout
from uvio_tpu_torch.types.state import init_state, state_from_numpy

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False  # the steps insist on full-float32 products
T64 = torch.float64

# `cholesky_solve`: on the card a batch of them runs MAGMA's potrs, which
# allocates device memory from the host (`filter/ekf.py` `cho_solve`)
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.equal",
             "aten.is_nonzero", "aten.unique", "aten._unique", "aten.lift_fresh", "aten.cholesky_solve",
             "aten._cholesky_solve_helper")
INDEXING = ("aten.index.", "aten.index_put", "aten._index_put_impl")


class Recorder(TorchDispatchMode):
    """Records every ATen operation and the ones that break a capture."""

    def __init__(self):
        super().__init__()
        self.ops, self.bad = 0, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops += 1
        if name.startswith(FORBIDDEN):
            self.bad.add(name)
        if name.startswith(INDEXING):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx):
                self.bad.add(name + " with a bool mask")
        return func(*args, **(kwargs or {}))


def _check(fn, *args, **kwargs):
    """fn's result: one warm-up call, then one recorded call that must
    run no forbidden operation; the replay's results are checked too."""
    fn(*args, **kwargs)
    with Recorder() as rec:
        out = fn(*args, **kwargs)
    assert rec.ops > 0
    assert not rec.bad, sorted(rec.bad)
    _assert_replay_results_fresh((args, kwargs), out)
    return out


def _storage(t):
    return t.untyped_storage().data_ptr()


def _assert_replay_results_fresh(inputs, out):
    """What a replay returns, built from these results: equal to them and
    sharing no memory with the inputs or with the results it came from
    (the graph's output buffers)."""
    outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
    packer = Packer(outs)
    static = packer.pack(outs)
    got = packer.unpack({dt: f.clone() for dt, f in static.items()})
    taken = {_storage(t) for t in tree_leaves(inputs) if isinstance(t, torch.Tensor)}
    taken |= {_storage(t) for t in outs} | {_storage(f) for f in static.values()}
    for g, o in zip(got, outs):
        assert g.dtype == o.dtype and g.shape == o.shape
        assert torch.equal(g, o) or torch.equal(g.isnan(), o.isnan())
        assert _storage(g) not in taken


@pytest.fixture(scope="module")
def fx():
    return load_full_step_fixture()


def _plans(fx):
    U = len(fx.bundles[0]["uwb_stamp"])
    return {
        "all_on": FramePlan(zupt_try=True, uwb_rows=(True,) * U, slam_init=True, marg=True),
        "all_off": FramePlan(zupt_try=False, uwb_rows=(False,) * U, slam_init=False, marg=False),
        "uwb_rows_mixed": FramePlan(zupt_try=False, uwb_rows=(True, False) * (U // 2) + (True,) * (U % 2),
                                    slam_init=True, marg=False),
    }


# (plan, ZUPT form): the fixture's scenario has no ZUPT, so only the
# forced plans run with one
FULL_STEP_CASES = [(p, "none") for p in ("fixture", "all_on", "all_off", "uwb_rows_mixed")] + [
    (p, z) for z in ("inertial", "explicit") for p in ("all_on", "all_off", "uwb_rows_mixed")]


@pytest.mark.parametrize("plan,zupt", FULL_STEP_CASES)
def test_full_step_capture_safe(fx, plan, zupt):
    """The full step at the fixture's full width (25 SLAM slots, 4 UWB
    anchors, 4 range sets), every plan bit on and off."""
    cfg = FullStepConfig.from_dict(fx.config)
    if zupt != "none":
        cfg = dataclasses.replace(cfg, try_zupt=True, zupt_explicit=zupt == "explicit")
    step = make_full_step(cfg).eager
    state = state_from_numpy(fx.state0, "cpu", T64)
    k = 0
    if plan == "fixture":  # a frame whose plan runs SLAM init and marginalization
        t = float(fx.state0["time"])
        for k, b in enumerate(fx.bundles):
            p = plan_frame(b, t)
            if p.slam_init and p.marg:
                break
            t = float(b["stamp_time"])
        state = state_from_numpy(fx.snapshots[k], "cpu", T64) if k in fx.snapshots else state
        the_plan = p
    else:
        the_plan = _plans(fx)[plan]
    st, infos = _check(step, state, bundle_from_numpy(fx.bundles[k], "cpu", T64), the_plan)
    assert st.cov.shape == state.cov.shape and "zupt_accepted" in infos


def test_packed_full_step_capture_safe(fx):
    """The managers' step: the bundle unpacked inside the graph."""
    step = make_packed_full_step(FullStepConfig.from_dict(fx.config)).eager
    state = state_from_numpy(fx.state0, "cpu", T64)
    flat, shapes = pack_bundle(fx.bundles[0], "cpu")
    plan = plan_frame(fx.bundles[0], float(fx.state0["time"]))
    st, _ = _check(step, state, flat, shapes, plan)
    ref, _ = make_full_step(FullStepConfig.from_dict(fx.config)).eager(
        state, bundle_from_numpy(fx.bundles[0], "cpu", T64), plan)
    assert torch.equal(st.cov, ref.cov)


@pytest.mark.parametrize("batched", [False, True])
def test_filter_step_capture_safe(fx, batched):
    """The MSCKF-only step on the fixture's first frame; batched, two
    sequences of it, the second with a full clone ring (so it
    marginalizes first)."""
    from uvio_tpu_torch.filter.propagator import NoiseManager

    c = fx.config
    cfg = StepConfig(layout=StateLayout(**c["layout"]), noises=NoiseManager(**c["noises"]),
                     sigma_pix=c["sigma_pix"])
    names = ("imu_t", "imu_w", "imu_a", "msckf_uv", "msckf_mask")
    args = [np.asarray(fx.bundles[0][n]) for n in names]
    arrays = dict(fx.state0)
    make = make_step
    if batched:
        full = dict(arrays, clones_valid=np.ones_like(arrays["clones_valid"]))
        arrays = {n: np.stack([arrays[n], full[n]]) for n in arrays}
        args = [np.stack([a, a]) for a in args]
        make = make_batched_step
    state = state_from_numpy(arrays, "cpu", T64)
    args = [torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else T64) for a in args]
    st, info = _check(make(cfg).eager, state, *args)
    assert st.cov.shape == state.cov.shape and "cov_ok" in info


@pytest.mark.parametrize("union", ["fixture", "all_on", "all_off"])
def test_batched_full_step_capture_safe(union):
    """Two of the batched fixture's sequences at full width, one frame,
    under their own union plan and under a forced one."""
    bfx = load_batched_fixture()
    state0, staged = stage_batched_fixture(bfx, B=2, frames=1, device="cpu", dtype=T64)
    fb, plan = staged[0]
    U = len(plan.union.uwb_rows)
    if union != "fixture":
        on = union == "all_on"
        plan = plan._replace(union=FramePlan(zupt_try=False, uwb_rows=(on,) * U, slam_init=on, marg=on))
    cfg = FullStepConfig.from_dict(bfx.config)
    st, infos = _check(make_batched_full_step(cfg).eager, state0, fb, plan)
    assert st.cov.shape == state0.cov.shape and infos["cov_ok"].shape == (2,)


def test_fused_step_capture_safe():
    """The fused image->pose step at 120x160, 3 levels, 24 tracks."""
    from uvio_tpu_torch.frontend.fused_vio import make_fused_vio_step

    L = StateLayout(max_clones=5, max_slam=0, max_imu_batch=8)
    intr = np.array([100.0, 100.0, 80.0, 60.0, 0, 0, 0, 0])
    step, make_carry = make_fused_vio_step(L, intr, 0, device="cpu", num_features=24, grid=(2, 3),
                                           levels=3, max_msckf_in_update=8)
    gen = torch.Generator().manual_seed(0)
    imgs = [torch.rand((120, 160), generator=gen) * 255.0 for _ in range(2)]
    st = init_state(L, dtype=torch.float32, device="cpu").replace(
        time=torch.tensor(0.0, dtype=T64), cov=torch.eye(L.dim) * 1e-4)
    t = torch.linspace(0.0, 0.1, 8, dtype=T64)
    w, a = torch.zeros(8, 3, dtype=T64), torch.tensor([0.0, 0.0, 9.81], dtype=T64).expand(8, 3).contiguous()
    gumbel = torch.rand((64, 8, 24), generator=gen)
    st, carry, info = _check(step.eager, st, make_carry(imgs[0]), imgs[1], t, w, a,
                             torch.tensor(0.1, dtype=T64), gumbel)
    assert len(carry[0]) == 3 and info["tracked"].shape == (24,)


def test_tracker_device_steps_capture_safe():
    """`KLTTracker`'s first-frame and tracking device steps at 120x160."""
    from uvio_tpu_torch.frontend.tracker import KLTTracker

    gen = torch.Generator().manual_seed(1)
    intr = np.array([100.0, 100.0, 80.0, 60.0, 0, 0, 0, 0])
    tr = KLTTracker(intr, num_features=24, grid=(3, 4), device="cpu")
    imgs = [(torch.rand((120, 160), generator=gen) * 255.0).numpy() for _ in range(2)]
    tr._fit_levels(imgs[0].shape)
    pyr, packed = _check(tr.step_first.eager, tr._upload(imgs[0]), tr._upload_table())
    assert packed.shape[1] == 3 and len(pyr) == tr.levels
    tr.feed(0.0, imgs[0])
    gumbel = torch.rand((64, 8, 24), generator=gen)
    pyr, packed = _check(tr.step_track.eager, tr.prev_pyr, tr._upload(imgs[1]), tr._upload_table(), gumbel)
    assert packed.shape[1] == 4 and packed.shape[0] > 24  # the 24 tracks with LK's ok, then the detections


STAGES = ("_stage_prop", "_stage_msckf", "_stage_marg", "_stage_slam_up", "_stage_slam_init", "_stage_marg_slam",
          "_stage_anchor_change", "_stage_prop_only", "_stage_uwb", "_stage_fast_prop")


@pytest.fixture(scope="module")
def staged():
    """A staged `UVioManager` on bench.py's scenario (25 SLAM slots, 4
    anchors, float64) driven 24 frames, past its first SLAM inits, then a
    landmark freed and a pose propagated at IMU rate; each graphed stage's
    body checked on its first call with the inputs the live loop gives it
    (`_check`). {stage: its checked result}."""
    from uvio_tpu_torch.eval.capture import bench_scenario, drive

    sim, mgr = bench_scenario(40, seed=7, max_slam=25, dtype="float64", device="cpu", fused_step=False)
    checked = {}

    def first_call(name, stage):
        def call(*args, **kwargs):
            if name in checked:
                return stage(*args, **kwargs)
            checked[name] = _check(stage.eager, *args, **kwargs)
            return checked[name]
        return call

    for name in STAGES:
        setattr(mgr, name, first_call(name, getattr(mgr, name)))
    drive(sim, mgr, 24)
    mgr._free_landmark(next(iter(mgr.slam_slot_by_fid)))
    for _ in range(4):
        mgr.feed_imu(*sim.get_next_imu())
    mgr.get_propagated_pose(mgr._imu_t[-1])
    return mgr, checked


@pytest.mark.parametrize("name", STAGES)
def test_staged_stage_capture_safe(staged, name):
    """Every graphed stage of the staged managers (`manager._stage`): the
    seven of `uvio_tpu`'s `_jit_*` run here, the anchor change, the UWB
    drain's propagation and update, and IMU-rate pose output."""
    mgr, checked = staged
    out = checked[name]
    if name == "_stage_fast_prop":
        assert out.shape == (10,)
    else:
        st = out[0] if isinstance(out, tuple) else out
        assert st.cov.shape == mgr.state.cov.shape


@pytest.mark.parametrize("explicit", [False, True], ids=["inertial", "explicit"])
def test_staged_zupt_capture_safe(staged, explicit):
    """The staged ZUPT attempt in both forms, on the driven state and the
    IMU since its last frame."""
    import dataclasses as dc

    from uvio_tpu_torch.uwb_manager import UVioManager

    mgr, _ = staged
    z = UVioManager(dc.replace(mgr.cfg, try_zupt=True, zupt_explicit=explicit))
    t = mgr._imu_t[-1]
    tt, ww, aa, _ = mgr._select_imu_window(t)
    st, accepted, gamma = _check(z._stage_zupt.eager, mgr.state, **mgr._window(tt, ww, aa, t))
    assert st.cov.shape == mgr.state.cov.shape and accepted.shape == gamma.shape == ()


def test_descriptor_device_steps_capture_safe():
    """`DescriptorTracker`'s first-frame and matching device steps at
    120x160."""
    from uvio_tpu_torch.frontend.descriptor import DescriptorTracker

    gen = torch.Generator().manual_seed(2)
    intr = np.array([100.0, 100.0, 80.0, 60.0, 0, 0, 0, 0])
    tr = DescriptorTracker(intr, grid=(3, 4), device="cpu")
    imgs = [torch.rand((120, 160), generator=gen) * 255.0 for _ in range(2)]
    desc, valid, packed = _check(tr.step_first.eager, imgs[0])
    assert packed.shape == (12, 3) and desc.shape == (12, 8)
    desc, valid, packed = _check(tr.step_match.eager, desc, valid, imgs[1])
    assert packed.shape == (12, 4) and valid.shape == (12,)


def test_stereo_match_capture_safe():
    """`KLTTracker.stereo_match`'s device step on a table padded to the
    tracker's capacity, at 120x160."""
    from uvio_tpu_torch.frontend.tracker import KLTTracker, to_device

    gen = torch.Generator().manual_seed(3)
    intr = np.array([100.0, 100.0, 80.0, 60.0, 0, 0, 0, 0])
    tr = KLTTracker(intr, num_features=24, grid=(3, 4), device="cpu")
    imgs = [(torch.rand((120, 160), generator=gen) * 255.0).numpy() for _ in range(2)]
    tr.feed(0.0, imgs[0])
    tab = np.zeros((tr.cap, 3), np.float32)
    tab[:5, :2], tab[:5, 2] = tr.uv[:5], 1.0
    packed = _check(tr.step_stereo.eager, tr.prev_pyr, tr._upload(imgs[1]), to_device(tab, tr.device))
    assert packed.shape == (tr.cap, 3)


def test_packer_views_are_aligned():
    """Every view of a packed buffer starts a multiple of `graphs.ALIGN`
    bytes into it, as a fresh allocation would: on the card, kernels that
    pick their code by operand alignment (cuBLAS's) then round a graph's
    inputs and outputs as they round the eager step's."""
    from uvio_tpu_torch.graphs import ALIGN

    ts = [torch.randn(3), torch.randn(182, 182, dtype=T64), torch.randn((), dtype=T64), torch.ones(5, dtype=torch.bool),
          torch.arange(7), torch.randn(0), torch.randn(128)]
    packer = Packer(ts)
    flats = packer.pack(ts)
    views = packer.unpack(flats)
    for t, v in zip(ts, views):
        assert torch.equal(t, v) and v.shape == t.shape and v.dtype == t.dtype
        assert (v.data_ptr() - flats[v.dtype].data_ptr()) % ALIGN == 0 or not v.numel()
    again = packer.unpack(packer.pack([t + 1 for t in ts[:2]] + ts[2:], out=flats))
    assert torch.equal(again[0], ts[0] + 1) and torch.equal(again[1], ts[1] + 1)

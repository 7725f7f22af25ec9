"""The SLAM delayed-init kernel on the card (`csrc/slam_init.cu`) against
its plain version, `update/slam.py` `slam_delayed_init_ref`, run on the
same card.

States (built on the CPU, so that no state depends on the kernel): the
EuRoC cell's layout (12 clone slots, 50 landmark slots, camera calibration:
D 252, one cluster of 8 blocks) and its stereo layout (D 266, 48 rows a
candidate) with 8 candidates of which an outlier, an inactive row and a
short track fail, on two seeds; and the committed replay fixture's frames
(the bench scenario's 25-slot layout, D 182) with the candidates they
carried. Float64 and float32; the cell's
representation (anchored MSCKF inverse depth), the single-depth one
(whose bearing rows and columns the kernel zeroes) and global 3D.

Tolerances: `inited` equal. The kernel splits each system by three
Householder reflections where the plain version forms a complete Q with
cuSOLVER, sums its products over the columns a candidate touches and in
another order, and takes chi2 as |L^-1 r|^2: only the rounding differs.
Float64 within 1e-10 of each field's largest magnitude (chi2 1e-10
relative); float32 within 1e-4.

Also: a candidate whose H_f holds a NaN is rejected with chi2 NaN and
changes nothing; a graph replay of the kernel is bitwise its eager launch
and adds one to `launch_counts` and `replay_counts`; the fused and staged
managers and the batched step launch it on the card, once a frame whose
plan has SLAM candidates, never run the plain version there, and hold
the landmarks the same scenario holds on the CPU (the plain version),
frame by frame. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`; on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_slam_init_kernel_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_slam_init_kernel import cell_case, fixture_case, spoiled
from uvio_tpu_torch.eval.capture import bench_scenario, drive
from uvio_tpu_torch.frontend import kernels as K
from uvio_tpu_torch.graphs import graphed
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import slam

pytestmark = pytest.mark.cuda
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the SLAM init kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def on(case, dev, dtype):
    """`case` with its state and inputs on `dev`, the state in `dtype`."""
    arrays = state_to_numpy(case.state)
    return dataclasses.replace(case, state=state_from_numpy(arrays, dev, dtype), uv=case.uv.to(dev),
                               mask=case.mask.to(dev), slots=case.slots.to(dev), ids=case.ids.to(dev))


def _close(got, gi, want, wi, tol):
    assert torch.equal(gi["inited"], wi["inited"])
    finite = torch.isfinite(wi["chi2"])
    assert torch.equal(finite, torch.isfinite(gi["chi2"]))
    torch.testing.assert_close(gi["chi2"][finite], wi["chi2"][finite], rtol=tol, atol=tol)
    for n in FIELDS:
        x, y = getattr(got, n), getattr(want, n)
        if x.dtype.is_floating_point:
            scale = max(float(y.abs().max()), 1.0) if y.numel() else 1.0
            torch.testing.assert_close(x, y, rtol=0, atol=tol * scale, msg=n)
        else:
            assert torch.equal(x, y), n


def _cases(name, rep):
    if name != "fixture":
        return [cell_case(rep, seed, cams=2 if name == "stereo" else 1) for seed in (0, 1)]
    return [fixture_case(rep, frame) for frame in (3, 16)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rep", [1, 5, 0])
@pytest.mark.parametrize("name", ["cell", "stereo", "fixture"])
def test_kernel_matches_the_plain_version(dev, name, rep, dtype):
    n_inited = 0
    for case in _cases(name, rep):
        c = on(case, dev, dtype)
        before = K.launch_counts["slam_init"]
        got, gi = slam.slam_delayed_init(*c.args(), sigma_pix=c.sigma_pix)
        torch.cuda.synchronize()
        assert K.launch_counts["slam_init"] == before + 1
        want, wi = slam.slam_delayed_init_ref(*c.args(), sigma_pix=c.sigma_pix)
        _close(got, gi, want, wi, TOL[dtype])
        n_inited += int(wi["inited"].sum())
        if name != "fixture":
            assert not wi["inited"][[2, 5, 6]].any()
        if rep == 5:  # the bearing rows and columns of every new slot are zero
            for s in c.slots[gi["inited"]].tolist():
                off = c.layout.slam_off + 3 * s
                assert not got.cov[off:off + 2].any() and not got.cov[:, off:off + 2].any()
    assert n_inited >= (1 if rep == 0 else 3)


def test_a_nonfinite_candidate_is_rejected(dev, monkeypatch):
    """Candidate 3's H_f holds a NaN: every column of its split is live,
    more than shared memory holds; it is rejected with chi2 NaN, as the
    plain version rejects it, and the others init as there."""
    monkeypatch.setattr(slam, "_candidate_systems", spoiled(slam._candidate_systems, "nonfinite", 3))
    c = on(cell_case(1), dev, torch.float64)
    got, gi = slam.slam_delayed_init(*c.args())
    want, wi = slam.slam_delayed_init_ref(*c.args())
    assert gi["chi2"][3].isnan() and wi["chi2"][3].isnan() and not gi["inited"][3]
    assert gi["inited"].sum() >= 3
    _close(got, gi, want, wi, TOL[torch.float64])


def test_graph_replay_is_bitwise_the_eager_launch(dev):
    c0 = on(cell_case(1), dev, torch.float64)
    step = graphed(lambda st, uv, m, s, i: slam.slam_delayed_init(st, c0.layout, uv, m, s, i, c0.cam_model),
                   "slam_delayed_init")
    for seed in range(3):
        c = on(cell_case(1, seed), dev, torch.float64)
        eager, ei = slam.slam_delayed_init(*c.args())
        if not step.entries:
            step(c.state, c.uv, c.mask, c.slots, c.ids)  # the capture
        l0, r0 = K.launch_counts["slam_init"], K.replay_counts["slam_init"]
        got, gi = step(c.state, c.uv, c.mask, c.slots, c.ids)
        torch.cuda.synchronize()
        assert (K.launch_counts["slam_init"], K.replay_counts["slam_init"]) == (l0 + 1, r0 + 1)
        assert torch.equal(gi["inited"], ei["inited"]) and torch.equal(gi["chi2"], ei["chi2"])
        for n in FIELDS:
            assert torch.equal(getattr(got, n), getattr(eager, n)), n
        assert ei["inited"].sum() >= 3
    assert step.stats()["graphs"] == 1


@pytest.fixture
def no_plain_on_the_card(monkeypatch):
    plain = slam.slam_delayed_init_ref

    def refuse(state, *args, **kw):
        assert state.cov.device.type != "cuda", "slam_delayed_init_ref ran on the card"
        return plain(state, *args, **kw)

    monkeypatch.setattr(slam, "slam_delayed_init_ref", refuse)


@pytest.mark.parametrize("fused", [True, False])
def test_managers_launch_the_kernel(dev, fused, no_plain_on_the_card):
    """A frame whose plan has SLAM candidates is one launch of the kernel,
    any other frame none; after every frame the manager holds the
    landmarks (feature id to slot) that the same scenario's manager holds
    on the CPU, where the plain version runs."""
    frames = 40
    held = {}
    for where in (dev, "cpu"):
        sim, mgr = bench_scenario(frames, seed=7, max_slam=25, dtype="float64", device=where, fused_step=fused)
        calls = []
        if not fused:
            stage = mgr._stage_slam_init
            mgr._stage_slam_init = lambda *a, _stage=stage, **kw: (calls.append(1), _stage(*a, **kw))[1]
        counts, cands, held[where] = [], [], []

        def frame(k, t):
            counts.append(K.launch_counts["slam_init"])
            cands.append(len(calls) if not fused else int(mgr.last_timing.get("slam_cands", 0) > 0))
            held[where].append(dict(mgr.slam_slot_by_fid))

        l0 = K.launch_counts["slam_init"]
        drive(sim, mgr, frames, on_frame=frame)
        per_frame = np.diff([l0, *counts])
        if where == dev:
            want = np.diff([0, *cands]) if not fused else np.asarray(cands)
            np.testing.assert_array_equal(per_frame, want)
            assert per_frame.sum() >= 3
        else:
            assert not per_frame.any()
    assert held[dev] == held["cpu"] and any(held[dev])


def test_batched_step_is_one_launch_a_frame(dev, no_plain_on_the_card):
    from uvio_tpu_torch.fixtures import load_batched_fixture
    from uvio_tpu_torch.pipeline import FullStepConfig, make_batched_full_step, plan_batch, stack_bundles

    fx = load_batched_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    step = make_batched_full_step(cfg)
    batch = state_from_numpy(fx.state0, dev)
    times = [float(t) for t in fx.state0["time"]]
    n_init = 0
    for frame in fx.bundles[:8]:
        plan = plan_batch(frame, times)
        before = K.launch_counts["slam_init"]
        batch, info = step(batch, *stack_bundles(frame, plan, dev))
        assert K.launch_counts["slam_init"] - before == int(plan.union.slam_init)
        n_init += int(plan.union.slam_init)
        times = [float(b["stamp_time"]) for b in frame]
    assert n_init >= 1

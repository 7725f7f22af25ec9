"""The UWB range-update kernel on the card (`csrc/uwb_update.cu`) against
its plain version, `update/uwb.py` `uwb_update_ref`, run on the same card.

States come from the benchmark scenario (`eval.capture.bench_scenario`,
driven on the CPU so that no state depends on the kernel) on two layouts:
the corridor's (12 clone slots, 8 anchor slots with 4 anchors, the lever
arm calibrated: D 130, whose float64 covariance the kernel stages in
shared memory) and the same with 25 SLAM slots (D 205, which in float64
does not fit and is updated in global memory). Each state meets the
scenario's next range set as it came, with one range masked, and with one
range moved 5 m so that it fails its gate.

Tolerances: `accepted` equal. The kernel sums H P H^T over H's 14
nonzeros where the plain version sums all D columns through cuBLAS, and
divides once by S where the plain version divides twice by its square
root, so only the rounding differs: float64 within 1e-12 of each field's
largest magnitude (about 5,000 ulps, for four chained updates); float32
within 1e-4 (about 1,000 ulps). chi2 within the same, relative, or
absolute where it is small: the residual is a range of ~5 m less its
prediction, so its rounding error is that of the ranges however few mm
the residual is, and a chi2 of 1e-4 carries it at 1e-12 relative.

Also: slots that end early between slots that update give the same
result bitwise over 200 launches; a graph replay of the kernel is bitwise
its eager launch and adds
one to `launch_counts` and `replay_counts`; the fused and staged managers
and the batched step launch it on the card and never run the plain
version there. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`; on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_uwb_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.eval.capture import bench_scenario, drive
from uvio_tpu_torch.frontend import kernels as K
from uvio_tpu_torch.graphs import Graphed, graphed
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import uwb

pytestmark = pytest.mark.cuda
CORRIDOR = dict(max_anchors=8, calib_uwb_extrinsics=True, p_IinU=np.array([0.05, -0.02, 0.1]))
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the UWB kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def scenario_cases(max_slam, frames=24, every=6):
    """(layout, [(state as numpy arrays, ranges (A,), mask (A,))]): the
    scenario's state after every `every`-th frame, float64 on the CPU,
    with the range set fed next, as it came, with one range masked and
    with one range moved 5 m."""
    sim, mgr = bench_scenario(frames, seed=7, max_slam=max_slam, dtype="float64", device="cpu", **CORRIDOR)
    fed = []
    feed = mgr.feed_uwb
    mgr.feed_uwb = lambda t, r: (fed.append(r), feed(t, r))
    snaps = []
    drive(sim, mgr, frames + 1, on_frame=lambda k, t: snaps.append((len(fed), state_to_numpy(mgr.state)))
          if k % every == every - 1 and k < frames else None)
    A = mgr.layout.max_anchors
    cases = []
    for n, st in snaps:
        ranges, mask = np.zeros(A), np.zeros(A, bool)
        for aid, d in fed[n].items():
            ranges[mgr.anchor_slot_by_id[aid]], mask[mgr.anchor_slot_by_id[aid]] = d, True
        masked, outlier = mask.copy(), ranges.copy()
        masked[np.flatnonzero(mask)[1]] = False
        outlier[np.flatnonzero(mask)[2]] += 5.0
        cases += [(st, ranges, mask), (st, ranges, masked), (st, outlier, mask)]
    return mgr.layout, mgr.ucfg.sigma_range, cases


def _close(got, gi, want, wi, tol):
    assert torch.equal(gi["accepted"], wi["accepted"])
    torch.testing.assert_close(gi["chi2"], wi["chi2"], rtol=tol, atol=tol)
    for n in FIELDS:
        x, y = getattr(got, n), getattr(want, n)
        if x.dtype.is_floating_point:
            scale = max(float(y.abs().max()), 1.0) if y.numel() else 1.0
            torch.testing.assert_close(x, y, rtol=0, atol=tol * scale, msg=n)
        else:
            assert torch.equal(x, y), n


@pytest.mark.parametrize("max_slam,dtype", [(0, torch.float64), (0, torch.float32), (25, torch.float64)])
def test_kernel_matches_the_plain_version(dev, max_slam, dtype):
    L, sigma, cases = scenario_cases(max_slam)
    assert L.dim == 130 + 3 * max_slam and L.max_anchors == 8
    assert uwb.uses_shared_memory(L, dtype) == (max_slam == 0 or dtype == torch.float32)
    n_acc = n_rej = 0
    for arrays, ranges, mask in cases:
        st = state_from_numpy(arrays, dev, dtype)
        r, m = torch.as_tensor(ranges, device=dev), torch.as_tensor(mask, device=dev)
        before = K.launch_counts["uwb_update"]
        got, gi = uwb.uwb_update(st, L, r, m, sigma_range=sigma)
        torch.cuda.synchronize()
        assert K.launch_counts["uwb_update"] == before + 1
        want, wi = uwb.uwb_update_ref(st, L, r, m, sigma_range=sigma)
        _close(got, gi, want, wi, TOL[dtype])
        acc = wi["accepted"].cpu().numpy()
        assert not (acc & ~mask).any()
        n_acc += acc.sum()
        n_rej += (mask & ~acc).sum()
    assert n_acc >= len(cases) and n_rej >= len(cases) // 3  # updates ran, and the outliers failed


def test_skipped_slots_repeat_bitwise(dev):
    """Slots that end early (masked, invalid or gated out) between slots
    that update, launched 200 times: every launch is bitwise the first,
    which matches the plain version. The block's threads meet at a barrier
    before each slot, so a slot's scalars are never rewritten while a slow
    warp still reads the last slot's; a launch that read them out of step
    would differ."""
    L, sigma, cases = scenario_cases(0, frames=6)
    arrays, ranges, mask = cases[0]
    st = state_from_numpy(arrays, dev)
    valid = np.flatnonzero(mask)
    outlier, gated = ranges.copy(), mask.copy()
    outlier[valid[0]] += 5.0
    gated[valid[2]] = False
    r, m = torch.as_tensor(outlier, device=dev), torch.as_tensor(gated, device=dev)
    first, fi = uwb.uwb_update(st, L, r, m, sigma_range=sigma)
    want, wi = uwb.uwb_update_ref(st, L, r, m, sigma_range=sigma)
    _close(first, fi, want, wi, TOL[torch.float64])
    acc = wi["accepted"].cpu().numpy()
    assert not acc[valid[0]] and not acc[valid[2]] and acc.sum() == len(valid) - 2
    for _ in range(200):
        got, gi = uwb.uwb_update(st, L, r, m, sigma_range=sigma)
        assert torch.equal(gi["accepted"], fi["accepted"]) and torch.equal(gi["chi2"], fi["chi2"])
        for n in ("cov", "q", "p", "anchors_p", "uwb_p_IinU"):
            assert torch.equal(getattr(got, n), getattr(first, n)), n


def test_graph_replay_is_bitwise_the_eager_launch(dev):
    L, sigma, cases = scenario_cases(0, frames=12)
    step = graphed(lambda st, r, m: uwb.uwb_update(st, L, r, m, sigma_range=sigma), "uwb_update")
    for arrays, ranges, mask in cases:
        st = state_from_numpy(arrays, dev)
        r, m = torch.as_tensor(ranges, device=dev), torch.as_tensor(mask, device=dev)
        eager, ei = uwb.uwb_update(st, L, r, m, sigma_range=sigma)
        if not step.entries:
            step(st, r, m)  # the capture
        l0, r0 = K.launch_counts["uwb_update"], K.replay_counts["uwb_update"]
        got, gi = step(st, r, m)
        torch.cuda.synchronize()
        assert (K.launch_counts["uwb_update"], K.replay_counts["uwb_update"]) == (l0 + 1, r0 + 1)
        assert torch.equal(gi["accepted"], ei["accepted"]) and torch.equal(gi["chi2"], ei["chi2"])
        for n in FIELDS:
            assert torch.equal(getattr(got, n), getattr(eager, n)), n
    assert step.stats()["graphs"] == 1


@pytest.fixture
def no_plain_on_the_card(monkeypatch):
    plain = uwb.uwb_update_ref

    def refuse(state, *args, **kw):
        assert state.cov.device.type != "cuda", "uwb_update_ref ran on the card"
        return plain(state, *args, **kw)

    monkeypatch.setattr(uwb, "uwb_update_ref", refuse)


@pytest.mark.parametrize("fused", [True, False])
def test_managers_launch_the_kernel_from_replays(dev, fused, no_plain_on_the_card):
    """Every range set the managers drain is one launch of the kernel, and
    every launch comes from a graph replay but those of each graph's first
    call (its eager warm-up)."""
    frames = 16
    sim, mgr = bench_scenario(frames, seed=7, max_slam=0, dtype="float64", device=dev,
                              fused_step=fused, **CORRIDOR)
    l0, r0 = K.launch_counts["uwb_update"], K.replay_counts["uwb_update"]
    counts = []
    drive(sim, mgr, frames, on_frame=lambda k, t: counts.append(K.launch_counts["uwb_update"]))
    # the scenario's 20 Hz range sets: two a 10 Hz frame once ranges flow
    launches = np.diff(counts)
    assert (launches[-8:] == 2).all(), launches
    first_calls = sum(e.launches.get("uwb_update", 0) for g in vars(mgr).values() if isinstance(g, Graphed)
                      for e in g.entries.values())
    assert first_calls >= 1
    assert (K.launch_counts["uwb_update"] - l0) - (K.replay_counts["uwb_update"] - r0) == first_calls


def test_batched_step_is_one_launch_a_range_set(dev, no_plain_on_the_card):
    from uvio_tpu_torch.fixtures import load_batched_fixture
    from uvio_tpu_torch.pipeline import FullStepConfig, make_batched_full_step, plan_batch, stack_bundles

    fx = load_batched_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    step = make_batched_full_step(cfg)
    batch = state_from_numpy(fx.state0, dev)
    times = [float(t) for t in fx.state0["time"]]
    for frame in fx.bundles[:4]:
        plan = plan_batch(frame, times)
        before = K.launch_counts["uwb_update"]
        batch, info = step(batch, *stack_bundles(frame, plan, dev))
        assert K.launch_counts["uwb_update"] - before == sum(plan.union.uwb_rows)
        times = [float(b["stamp_time"]) for b in frame]
    assert info["uwb_accepted"].any()

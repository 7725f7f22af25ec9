"""The MSCKF update kernel on the card (`csrc/msckf_update.cu`) against its
plain version, `update/msckf.py` `msckf_update_ref`, run on the same card.

States (built on the CPU, so that no state depends on the kernel): the
corridor cell's layout (D 130, W 75), the EuRoC cell's (D 252, W 87) and
its stereo layout (D 266, W 101, 48 rows a feature), each with 40
features of which an outlier, one seen once and a padding row fail, on two
seeds; and the committed replay fixture's frames (the bench scenario's
layout, D 182). Float64 and float32.

Tolerances: `kept` and `tri_ok` equal. The kernel projects each feature's
unpacked rows by three Householder reflections where the plain version
forms a complete Q of the packed rows with cuSOLVER, compresses over the
live columns where the plain version runs a D-column QR, and solves its
W-row system by an explicit S^-1: only the rounding differs. Float64
within 1e-10 of each field's largest magnitude (chi2 1e-10 relative);
float32 within 1e-4.

Also: a graph replay of the kernel is bitwise its eager launch and adds one
to `launch_counts` and `replay_counts`; the fused and staged managers
launch it once a frame they run the MSCKF update on the card, never run
the plain version there, and hold the states the same scenario holds on
the CPU (the plain version), frame by frame; the batched step launches it
once a frame for the whole batch. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`; on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_msckf_kernel_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_msckf_kernel import fixture_case, layout_case
from uvio_tpu_torch.eval.capture import bench_scenario, drive
from uvio_tpu_torch.frontend import kernels as K
from uvio_tpu_torch.graphs import graphed
from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy
from uvio_tpu_torch.update import msckf

pytestmark = pytest.mark.cuda
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the MSCKF update kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def on(case, dev, dtype):
    """`case` with its state and inputs on `dev`, the state in `dtype`."""
    return dataclasses.replace(case, state=state_from_numpy(state_to_numpy(case.state), dev, dtype),
                               uv=case.uv.to(dev), mask=case.mask.to(dev))


def close(got, gi, want, wi, tol):
    for k in ("tri_ok", "kept", "num_used", "cov_ok"):
        assert torch.equal(gi[k], wi[k]), k
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


def cases(name):
    if name == "fixture":
        return [fixture_case(frame) for frame in (3, 16)]
    return [layout_case(name, seed) for seed in (0, 1)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["corridor", "euroc", "stereo", "fixture"])
def test_kernel_matches_the_plain_version(dev, name, dtype):
    used = 0
    for case in cases(name):
        c = on(case, dev, dtype)
        before = K.launch_counts["msckf_update"]
        got, gi = msckf.msckf_update(*c.args(), sigma_pix=c.sigma_pix)
        torch.cuda.synchronize()
        assert K.launch_counts["msckf_update"] == before + 1
        want, wi = msckf.msckf_update_ref(*c.args(), sigma_pix=c.sigma_pix)
        close(got, gi, want, wi, TOL[dtype])
        used += int(wi["num_used"])
        if name != "fixture":
            assert not wi["kept"][[2, 5, 8]].any()
    assert used >= (2 if name == "fixture" else 40)


def test_graph_replay_is_bitwise_the_eager_launch(dev):
    c0 = on(layout_case("euroc"), dev, torch.float64)
    step = graphed(lambda st, uv, m: msckf.msckf_update(st, c0.layout, c0.cam_model, uv, m), "msckf_update")
    for seed in range(3):
        c = on(layout_case("euroc", seed), dev, torch.float64)
        eager, ei = msckf.msckf_update(*c.args())
        if not step.entries:
            step(c.state, c.uv, c.mask)  # the capture
        l0, r0 = K.launch_counts["msckf_update"], K.replay_counts["msckf_update"]
        got, gi = step(c.state, c.uv, c.mask)
        torch.cuda.synchronize()
        assert (K.launch_counts["msckf_update"], K.replay_counts["msckf_update"]) == (l0 + 1, r0 + 1)
        for k in ei:
            assert torch.equal(gi[k], ei[k]), k
        for n in FIELDS:
            assert torch.equal(getattr(got, n), getattr(eager, n)), n
        assert ei["num_used"] >= 10
    assert step.stats()["graphs"] == 1


@pytest.fixture
def no_plain_on_the_card(monkeypatch):
    plain = msckf.msckf_update_ref

    def refuse(state, *args, **kw):
        assert state.cov.device.type != "cuda", "msckf_update_ref ran on the card"
        return plain(state, *args, **kw)

    monkeypatch.setattr(msckf, "msckf_update_ref", refuse)


@pytest.mark.parametrize("fused", [True, False])
def test_managers_launch_the_kernel(dev, fused, no_plain_on_the_card):
    """The fused step runs the MSCKF update every frame once the filter
    runs, the staged path on every frame with features: one launch each;
    after every frame the manager's state equals the state of the same
    scenario's manager on the CPU, where the plain version runs."""
    frames = 40
    states = {}
    for where in (dev, "cpu"):
        sim, mgr = bench_scenario(frames, seed=7, max_slam=25, dtype="float64", device=where, fused_step=fused)
        calls = []  # the staged update's calls (on frames with features) and the fused steps
        for name in ("_stage_msckf", "_jit_full") if fused else ("_stage_msckf",):
            fn = getattr(mgr, name)
            setattr(mgr, name, lambda *a, _fn=fn, **kw: (calls.append(1), _fn(*a, **kw))[1])
        launched, ran, states[where] = [], [], []

        def frame(k, t):
            launched.append(K.launch_counts["msckf_update"])
            ran.append(len(calls))
            states[where].append({n: getattr(mgr.state, n).detach().cpu().clone() for n in ("p", "q", "v", "cov")})

        l0 = K.launch_counts["msckf_update"]
        drive(sim, mgr, frames, on_frame=frame)
        per_frame = np.diff([l0, *launched])
        if where == dev:
            np.testing.assert_array_equal(per_frame, np.diff([0, *ran]))
            assert per_frame.sum() >= 20
        else:
            assert not per_frame.any()
    for k, (a, b) in enumerate(zip(states[dev], states["cpu"])):
        for n in a:
            scale = max(float(b[n].abs().max()), 1.0)
            torch.testing.assert_close(a[n], b[n], rtol=0, atol=1e-8 * scale, msg=f"frame {k} {n}")


def test_batched_step_is_one_launch_a_frame(dev, no_plain_on_the_card):
    from uvio_tpu_torch.fixtures import load_batched_fixture
    from uvio_tpu_torch.pipeline import FullStepConfig, make_batched_full_step, plan_batch, stack_bundles

    fx = load_batched_fixture()
    cfg = FullStepConfig.from_dict(fx.config)
    step = make_batched_full_step(cfg)
    batch = state_from_numpy(fx.state0, dev)
    times = [float(t) for t in fx.state0["time"]]
    used = 0
    for frame in fx.bundles[:8]:
        plan = plan_batch(frame, times)
        before = K.launch_counts["msckf_update"]
        batch, info = step(batch, *stack_bundles(frame, plan, dev))
        assert K.launch_counts["msckf_update"] - before == 1
        used += int(info["msckf"]["num_used"].sum())
        times = [float(b["stamp_time"]) for b in frame]
    assert used >= 1

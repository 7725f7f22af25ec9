"""Tracing on the card (`uvio_tpu_torch/tracing.py`): the device marks
inside the fused step's CUDA graph and the replay events around it.

Over 40 frames of the benchmark scenario (`eval.capture.bench_scenario`,
fed as fast as it goes) two managers, one built with tracing off and one
with it on, end in bitwise equal filter states after every frame with the
same number of captured graphs; the traced one's rows carry the graph's
device ms: the marks tile every replay, and the filter's own stages (the
UWB drain, propagate + clone, the MSCKF update, marginalization) add up to
within 10% of it in the median frame, the bundle's unpacking and the
outputs' packing taking the rest (a graph's first replay also uploads it,
which lengthens its first stage). The staged manager, traced, takes each
stage's device ms from its graphs' replay events. Skips without a CUDA
device.

Imports neither JAX nor `uvio_tpu`; on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda -s tests/test_torch_tracing_cuda.py
"""

import dataclasses

import pytest
import torch

from uvio_tpu_torch import tracing
from uvio_tpu_torch.eval.capture import bench_scenario, drive
from uvio_tpu_torch.graphs import Graphed

pytestmark = pytest.mark.cuda
FRAMES = 40
STAGES = ("unpack", "uwb_drain", "propagate_clone", "msckf", "slam", "marginalize", "zupt", "outputs")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device marks live in CUDA graphs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda:0")
    tracing.enable(False)


def scenario_run(on: bool, device):
    """The benchmark scenario's first `FRAMES` frames (`eval.capture`:
    float64, four UWB anchors, 11 clones, 40 MSCKF features an update, no
    SLAM) through a fused manager built with tracing `on`: (states after
    each frame as host tensors, rows, graphs captured)."""
    tracing.enable(on)
    try:
        sim, mgr = bench_scenario(FRAMES, seed=11, max_slam=0, dtype="float64", device=device)
    finally:
        tracing.enable(False)
    states, rows = [], []

    def keep(k, t):
        st = mgr.state
        states.append({f.name: getattr(st, f.name).cpu() for f in dataclasses.fields(st)})
        rows.append(dict(mgr.last_timing))

    drive(sim, mgr, FRAMES, on_frame=keep)
    return states, rows, sum(g.stats()["graphs"] for g in vars(mgr).values() if isinstance(g, Graphed))


def test_traced_states_are_bitwise_the_untraced_ones(dev):
    s_off, r_off, g_off = scenario_run(False, dev)
    s_on, r_on, g_on = scenario_run(True, dev)
    assert len(s_off) == len(s_on) == FRAMES
    assert g_on == g_off
    for k, (a, b) in enumerate(zip(s_off, s_on)):
        for name in a:
            assert torch.equal(a[name], b[name]), (k, name)
    assert not any("device" in r for r in r_off)
    replayed = [r for r in r_on if r["capture_ms"] == 0.0]
    assert len(replayed) >= FRAMES - 2 * g_on
    sums = []
    for r in replayed:
        d = r["device"]
        assert {"graph", "unpack", "propagate_clone", "msckf", "outputs"} <= set(d) <= {"graph", *STAGES}
        assert r["msckf"] == d["msckf"] / 1e3 and r["slam"] == d.get("slam", 0.0) / 1e3
        assert all(v >= 0.0 for v in d.values())
        sums.append((sum(v for k, v in d.items() if k != "graph"),
                     sum(v for k, v in d.items() if k not in ("graph", "unpack", "outputs")), d["graph"]))
    assert any("uwb_drain" in r["device"] for r in replayed)
    assert any("marginalize" in r["device"] for r in replayed)
    for marked, _, graph in sums:
        assert marked == pytest.approx(graph, rel=1e-3)
    share = sorted(f / g for _, f, g in sums)
    assert share[len(share) // 2] >= 0.9, share
    print(f"graph ms median {sorted(g for _, _, g in sums)[len(sums) // 2]:.3f}, filter stages/graph "
          f"median {share[len(share) // 2]:.4f}, range {share[0]:.4f}-{share[-1]:.4f}, "
          f"unpack ms max {max(r['device']['unpack'] for r in replayed):.3f}")


def test_traced_staged_rows_take_the_replays_device_ms(dev):
    tracing.enable(True)
    try:
        sim, mgr = bench_scenario(24, seed=3, max_slam=4, dtype="float64", device=dev, fused_step=False)
    finally:
        tracing.enable(False)
    rows = []
    drive(sim, mgr, 24, on_frame=lambda k, t: rows.append(dict(mgr.last_timing)))
    late = rows[-6:]  # the ring is full and the marginalization's graph captured
    cols = {"uwb_drain": "uwb", "propagate_clone": "propagation", "msckf": "msckf", "slam": "slam",
            "marginalize": "marginalization"}
    for r in late:
        d = r["device"]
        assert {"propagate_clone", "marginalize"} <= set(d) <= set(cols)
        for stage, ms in d.items():
            assert ms > 0.0 and r[cols[stage]] == ms / 1e3

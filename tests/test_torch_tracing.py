"""The program's tracing switch (`uvio_tpu_torch/tracing.py`) and the
frame's timing row (`VioManager.last_timing`) on the CPU.

Off (the default): `span` is one shared no-op, nothing reaches the
profiler, and the row keeps the staged CSV's seven columns beside the
frame's host spans. On: every span is filled, the spans tile the frame
from `feed_features`' entry to its return, and under `torch.profiler`
each `uvio/` range nests inside its parent and inside the caller's range
(without a profiler no range is opened). Device marks and replay events
exist only on the card (`tests/test_torch_tracing_cuda.py`).
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from uvio_tpu_torch import tracing
from uvio_tpu_torch.eval.capture import bench_scenario, drive

LEGACY = ("timestamp", "uwb", "propagation", "msckf", "slam", "marginalization", "total")
SPANS = ("ingest", "build", "plan", "pack", "readback", "post")
# each program span and the span it lies in
PARENT = {"ingest": "frame", "build": "frame", "step": "frame", "post": "frame",
          "plan": "step", "pack": "step", "readback": "step"}


@pytest.fixture(autouse=True)
def full_precision():
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    tracing.enable(False)


def scenario(on: bool, n_frames: int = 10, fused_step: bool = True):
    """(sim, mgr) of a short UWB + SLAM scenario, the manager built with
    tracing `on` and the switch left off."""
    tracing.enable(on)
    try:
        return bench_scenario(n_frames, seed=3, max_slam=4, dtype="float64", device="cpu", fused_step=fused_step)
    finally:
        tracing.enable(False)


def timed_rows(sim, mgr, n_frames: int, caller=None):
    """Drive `n_frames` frames; per frame the manager's row and the host
    clock at `feed_features`' return (a frame the manager drops keeps the
    row before it, and is left out). `caller` wraps each frame in a range
    of that name."""
    rows, feed = [], mgr.feed_features

    def timed(t, obs):
        before = mgr.last_timing
        if caller is None:
            feed(t, obs)
        else:
            with record_function(caller):
                feed(t, obs)
        done = time.perf_counter()
        if mgr.last_timing is not before:
            rows.append((dict(mgr.last_timing), done))

    mgr.feed_features = timed
    drive(sim, mgr, n_frames)
    return rows


def test_off_is_the_shared_no_op_and_records_nothing():
    assert not tracing.enabled()
    assert tracing.span("frame") is tracing.NO_SPAN and tracing.span("step") is tracing.NO_SPAN
    tracing.mark("msckf")  # outside a traced capture: nothing to record, no card needed
    sim, mgr = scenario(False)
    assert not mgr.tracing and mgr._span("frame") is tracing.NO_SPAN
    assert not mgr.full_step.trace and not mgr._stage_uwb.trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rows = timed_rows(sim, mgr, 10)
    assert len(rows) >= 8
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith(tracing.PREFIX)]
    for row, _ in rows:
        assert all(k in row and row[k] >= 0.0 for k in LEGACY)
        assert row["msckf"] == row["slam"] == 0.0 and "device" not in row
    assert not mgr.full_step.take_timed()


def test_on_fills_the_spans_and_they_tile_the_frame():
    sim, mgr = scenario(True)
    assert mgr.tracing and mgr.full_step.trace and not tracing.enabled()
    rows = timed_rows(sim, mgr, 10)
    assert len(rows) >= 8
    for row, done in rows:
        assert all(row[k] >= 0.0 for k in SPANS + LEGACY)
        # the legacy columns are the spans they always were
        assert (row["uwb"], row["propagation"]) == (row["build"], row["step"])
        assert row["total"] == row["uwb"] + row["propagation"] + row["marginalization"]
        assert row["post"] >= row["marginalization"]
        assert row["plan"] + row["pack"] + row["readback"] == pytest.approx(row["step"], abs=1e-9)
        assert row["capture_ms"] == 0.0  # the CPU captures nothing
        assert "device" not in row  # no events on the CPU
        service = done - row["t_start"]
        assert abs(sum(row[k] for k in SPANS) - service) < 50e-6, (row, service)


def test_program_ranges_nest_inside_the_caller():
    sim, mgr = scenario(True, n_frames=6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rows = timed_rows(sim, mgr, 6, caller="caller")
    ranges = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events())
    callers = [(a, b) for n, a, b in ranges if n == "caller"]
    ours = [(n[len(tracing.PREFIX):], a, b) for n, a, b in ranges if n.startswith(tracing.PREFIX)]
    assert len(callers) == 6
    # the frames the manager runs (the first ones initialize it) have every span
    assert sum(n == "frame" for n, _, _ in ours) == 6
    for name in PARENT:
        assert sum(n == name for n, _, _ in ours) == len(rows), name
    for name, a, b in ours:
        assert any(c0 <= a and b <= c1 for c0, c1 in callers), name
        if name in PARENT:
            assert any(n == PARENT[name] and p0 <= a and b <= p1 for n, p0, p1 in ours), name


def test_staged_rows_keep_host_times_without_syncs():
    """The staged path's row: host times per stage (no synchronization
    between stages); traced, on the CPU, still host times (no replays)."""
    for on in (False, True):
        sim, mgr = scenario(on, n_frames=6, fused_step=False)
        rows = timed_rows(sim, mgr, 6)
        assert rows
        for row, _ in rows:
            assert all(row[k] >= 0.0 for k in LEGACY) and "device" not in row
            assert row["total"] >= row["uwb"] + row["propagation"] + row["msckf"]


def test_record_timing_turns_tracing_on(tmp_path):
    sim, mgr = scenario(False, n_frames=6)
    path = tmp_path / "timing.csv"
    mgr.record_timing(str(path))
    try:
        assert tracing.enabled() and mgr.tracing and mgr.full_step.trace
        assert mgr._span("frame") is tracing.NO_SPAN  # no profiler records
        with profile(activities=[ProfilerActivity.CPU]):
            assert mgr._span("frame") is not tracing.NO_SPAN
        drive(sim, mgr, 6)
    finally:
        mgr._timing_file.close()
        tracing.enable(False)
    lines = path.read_text().splitlines()
    assert lines[0] == "# timestamp,uwb,propagation,msckf,slam,marginalization,total"
    assert len(lines) >= 5 and all(len(x.split(",")) == 7 for x in lines[1:])

"""`correct` on the CPU at a small size: true for the program, false for
the control in its place and for each fault the cell can have, planted
underneath a run that skips only the harness's look for a card."""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from port_bench import check, harness
from port_bench.harness import run_cell
from port_bench.readings import reading
from port_bench.traffic.generate import make_traffic

CELL = "uwb_corridor.live"
SMALL = dict(frames=8, warmup_s=1.5)


def program(fault=None):
    """The port as a package, or with `fault` planted in its manager."""
    import uvio_tpu_torch
    import uvio_tpu_torch.manager
    import uvio_tpu_torch.utils.config  # noqa: F401
    from uvio_tpu_torch.uwb_manager import UVioManager

    if fault is None:
        return uvio_tpu_torch

    class Faulty(UVioManager):
        frames = 0

        def _frame_fused(self, t):
            before = self.state
            super()._frame_fused(t)
            self.frames += 1
            if fault == "state_unchanged":  # the step returns its state unchanged
                self.state = before
            elif fault == "pose_altered" and self.frames == 3:  # one frame's pose 1 mm off
                self.state = self.state.replace(p=self.state.p + 1e-3)

    return types.SimpleNamespace(utils=uvio_tpu_torch.utils, manager=uvio_tpu_torch.manager,
                                 uwb_manager=types.SimpleNamespace(UVioManager=Faulty))


SEED = 1234567890123


def cpu_run(pkg):
    return run_cell(CELL, SEED, 1.0, False, "cpu", time.perf_counter(), program=pkg, **SMALL)


def test_the_program_is_correct():
    r = cpu_run(program())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == SMALL["frames"]
    assert list(r)[-1] == "checks" and r["checks"]
    assert set(r["metrics"]) == {"setup_s", "pose_latency_p50_ms", "pose_latency_p95_ms"}
    # the independent reference follows the port to round-off, far inside every limit
    assert all(c["value"] <= 1e-3 * c["limit"] or c["value"] == c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", ["state_unchanged", "pose_altered"])
def test_a_fault_is_not_correct(fault):
    r = cpu_run(program(fault))
    assert not r["correct"]
    assert any(c["limit"] < (c["value"] if isinstance(c["value"], float) else float("inf")) for c in r["checks"].values())


def test_the_control_is_not_correct():
    """The program's own float32 path in place of the configuration's
    float64."""
    r = reading(CELL, 987654321, 1.0, "cpu", "control", **SMALL)
    assert not r["correct"]
    assert r["checks"]["pose_gap_m"]["value"] > r["checks"]["pose_gap_m"]["limit"]


def test_the_readings_of_the_program_are_correct():
    r = reading(CELL, 987654321, 1.0, "cpu", "program", **SMALL)
    assert r["correct"] and r["frames"] == r["of"]
    assert np.isfinite([c["value"] for c in r["checks"].values()]).all()


def assert_same(a, b):
    """Equal exactly, through lists, tuples, dicts, arrays and tensors."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        assert type(a) is type(b) and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), strict=True)
    else:
        assert a == b


def test_the_corridor_reads_the_same_through_its_driver(monkeypatch):
    """The configuration's `system` dispatches to `drivers/vio.py`: the run
    is fed `traffic/generate.py`'s traffic bit for bit, and its checks are
    `check.judge`'s for the outputs it judged."""
    _, config, mix = harness.cell_files(CELL)
    drv = harness.driver(config["system"])
    seen = {}

    def keeping(config, traffic, out, root):
        seen.update(traffic=traffic, out=out)
        return judge(config, traffic, out, root)

    judge = drv.judge
    monkeypatch.setattr(drv, "judge", keeping)
    r = cpu_run(program())
    ours = make_traffic(config, dict(mix, warmup_s=SMALL["warmup_s"]), SEED, 1.0, harness.BENCH_DIR,
                        frames=SMALL["frames"])
    for f in dataclasses.fields(ours.stream):
        assert_same(getattr(seen["traffic"].stream, f.name), getattr(ours.stream, f.name))
    for k in ("n_warmup", "n_window", "gt0", "uwb_mask"):
        assert_same(getattr(seen["traffic"], k), getattr(ours, k))
    assert len(seen["out"].rows) == ours.n_warmup + ours.n_window
    checks = check.judge(config, ours, seen["out"], harness.BENCH_DIR)
    assert r["correct"] and {k: c["value"] for k, c in r["checks"].items()} == {k: v for k, (v, _) in checks.items()}
    assert {k: c["limit"] for k, c in r["checks"].items()} == config["limits"]

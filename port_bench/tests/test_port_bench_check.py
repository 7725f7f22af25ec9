"""`correct` on the CPU at a small size: true for the program, false for
the control in its place and for each fault the cell can have, planted
underneath a run that skips only the harness's look for a card."""

import time
import types

import numpy as np
import pytest

from port_bench.harness import run_cell
from port_bench.readings import reading

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


def cpu_run(pkg):
    return run_cell(CELL, 1234567890123, 1.0, False, "cpu", time.perf_counter(), program=pkg, **SMALL)


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

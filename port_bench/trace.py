"""The traced run's device trace: a bounded run of consecutive frames
inside the window under `torch.profiler`, and what is read from it.

The trace opens with `WARM_KERNELS` spin kernels (copied from the repo's
`chip_smoke.launch_profile`): late in a long process the profiler drops
the first few device records of a trace, and the spins absorb the loss.
The harness marks its own host spans with `record_function` (a frame's
service, which is the manager's `feed_features`, and each IMU sample and
range set), so device activity can be laid against them:

  * per frame, the union of device activity inside its service interval
    (from its call into the program to its pose in host memory);
  * device time by operation name;
  * the idle gaps between device operations, each named by the host span
    it falls in.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WARM_KERNELS = 32
TRACED_FRAMES = 10  # consecutive frames from the middle of the window
SPANS = ("frame", "feed_imu", "feed_uwb")


class Tracer:
    """One profiler session over `TRACED_FRAMES` frames."""

    def __init__(self):
        self.prof = None
        self.events: List[Tuple[str, bool, int, int]] = []  # (name, on device, start ns, end ns)
        self.start_s = self.stop_s = 0.0

    @staticmethod
    def warm():
        """One short session during set-up, so that the profiler's first
        start (CUPTI's set-up) does not fall into the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda._sleep(1)
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(WARM_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.start_s = time.perf_counter() - t0

    def span(self, name: str):
        return torch.profiler.record_function(name)

    def stop(self):
        from torch.autograd import DeviceType

        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events():
            on_dev = e.device_type() == DeviceType.CUDA
            name = e.name()
            # the spins, and the device-side copies of the harness's spans
            if on_dev and ("spin_kernel" in name or name in SPANS):
                continue
            if on_dev or name in SPANS:
                self.events.append((name, on_dev, e.start_ns(), e.start_ns() + e.duration_ns()))
        self.prof = None
        self.stop_s = time.perf_counter() - t0


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering the (n, 2) intervals `iv`."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, dtype=np.int64)


def _covered(union: np.ndarray, a: int, b: int) -> int:
    """ns of [a, b] that the disjoint intervals cover."""
    if len(union) == 0:
        return 0
    lo, hi = np.maximum(union[:, 0], a), np.minimum(union[:, 1], b)
    return int(np.clip(hi - lo, 0, None).sum())


class TraceData:
    """What the readers take from a trace."""

    def __init__(self, events, frame_timing: List[dict], stages):
        dev = [(n, a, b) for n, d, a, b in events if d]
        host = [(n, a, b) for n, d, a, b in events if not d]
        frames = sorted([(a, b) for n, a, b in host if n == "frame"])
        self.frames = frames
        self.union = _union(np.asarray([(a, b) for _, a, b in dev], dtype=np.int64))
        self.busy_in_frame_s = [_covered(self.union, a, b) / 1e9 for a, b in frames]
        self.frame_s = [(b - a) / 1e9 for a, b in frames]
        if frames:
            w0, w1 = frames[0][0], frames[-1][1]
            self.window_s = (w1 - w0) / 1e9
            self.busy_s = _covered(self.union, w0, w1) / 1e9
        else:
            self.window_s = self.busy_s = 0.0
        by_op: Dict[str, float] = {}
        for n, a, b in dev:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e9
        self.device_ops = sorted(by_op.items(), key=lambda x: -x[1])[:10]
        self.idle_gaps = self._gaps(host, frame_timing, stages)

    def _gaps(self, host, frame_timing, stages) -> List[list]:
        """The ten longest gaps between device operations inside the
        traced window, each named by the innermost harness span it falls
        in; inside a frame, by the frame's own stage: `stages`, the
        driver's ((key, name), ...), laid end to end from the frame's
        start with the durations of its timing row, the last taking the
        rest."""
        if not self.frames or len(self.union) < 2:
            return []
        w0, w1 = self.frames[0][0], self.frames[-1][1]
        u = self.union[(self.union[:, 1] > w0) & (self.union[:, 0] < w1)]
        gaps = [(int(u[i, 1]), int(u[i + 1, 0])) for i in range(len(u) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        ff = self.frames
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            name = "between events (waiting for the sensors)"
            best = None
            for n, s, e in host:
                if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                    best, name = (s, e), n
            if name == "frame":
                i = next((j for j, (s, e) in enumerate(ff) if s <= mid <= e), None)
                if i is not None and i < len(frame_timing) and frame_timing[i] is not None:
                    t = frame_timing[i]
                    off = (mid - ff[i][0]) / 1e9
                    end = 0.0
                    for key, stage in stages:
                        end += t[key]
                        name = f"frame: {stage}"
                        if off < end:
                            break
            out.append([name, (b - a) / 1e9])
        return out


def summarize(tracer: Optional[Tracer], frame_timing, stages) -> Optional[TraceData]:
    return None if tracer is None or not tracer.events else TraceData(tracer.events, frame_timing, stages)

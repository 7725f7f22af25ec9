"""device_busy_ms: the union of device activity (kernels, copies)
inside a frame's service interval, from its first call into the program
to its pose in host memory, mean over the traced frames (profiler)."""

import numpy as np


def read(run):
    t = run.trace
    if t is None or not t.busy_in_frame_s:
        return None
    return float(np.mean(t.busy_in_frame_s)) * 1e3

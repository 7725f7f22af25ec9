"""pose_latency_p50_ms: the median over every frame due in the window of
the time from the frame's due time to its pose in host memory, host
clock; a frame with no pose counts from its due time to the run's end."""

import numpy as np


def read(run):
    return float(np.median([f["latency_s"] for f in run.frames])) * 1e3

"""pose_latency_p95_ms: the 95th percentile (linear interpolation) over
every frame due in the window of the time from its due time to its pose
in host memory, host clock; a frame with no pose counts from its due
time to the run's end."""

import numpy as np


def read(run):
    return float(np.percentile([f["latency_s"] for f in run.frames], 95)) * 1e3

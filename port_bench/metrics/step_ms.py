"""step_ms: the manager's device step a frame, its `last_timing` step
(dispatch to the frame's one read-back), mean over the window's frames
outside the traced stretch."""

import numpy as np


def read(run):
    v = [f["step_s"] for f in run.frames if not f["traced"] and f["done"] is not None]
    return float(np.mean(v)) * 1e3 if v else None

"""track_host_ms: the tracker's host part a frame without its wait for
the device: `upload` + `replay` (to the graphed call's return) + `spawn`
of its `last_timing`, mean over the window's frames outside the traced
stretch. None for a system without them."""

import numpy as np


def read(run):
    keys = ("upload_s", "replay_s", "spawn_s")
    v = [sum(f[k] for k in keys) for f in run.frames
         if not f["traced"] and f["done"] is not None and all(k in f for k in keys)]
    return float(np.mean(v)) * 1e3 if v else None

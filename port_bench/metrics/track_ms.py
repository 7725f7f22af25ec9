"""track_ms: the tracker's whole `feed` a frame (its `last_timing`
`track`: upload, graph replay, read-back, spawn), mean over the window's
frames outside the traced stretch. None for a system without it."""

import numpy as np


def read(run):
    v = [f["track_s"] for f in run.frames if not f["traced"] and f["done"] is not None and "track_s" in f]
    return float(np.mean(v)) * 1e3 if v else None

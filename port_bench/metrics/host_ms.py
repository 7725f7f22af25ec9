"""host_ms: the manager's host work a frame, its `last_timing` bundle
build plus bookkeeping, mean over the window's frames outside the
traced stretch."""

import numpy as np


def read(run):
    v = [f["build_s"] + f["post_s"] for f in run.frames if not f["traced"] and f["done"] is not None]
    return float(np.mean(v)) * 1e3 if v else None

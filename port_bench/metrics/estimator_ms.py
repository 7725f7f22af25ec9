"""estimator_ms: the filter a frame, from `feed_features`' entry to its
return (ingest, bundle build, step to the read-back, bookkeeping), mean
over the window's frames outside the traced stretch. None for a system
without it."""

import numpy as np


def read(run):
    v = [f["estimator_s"] for f in run.frames if not f["traced"] and f["done"] is not None and "estimator_s" in f]
    return float(np.mean(v)) * 1e3 if v else None

"""device_idle_in_frame_pct: the share of the traced frames' service
intervals in which nothing ran on the device (profiler)."""


def read(run):
    t = run.trace
    if t is None or not t.frame_s or sum(t.frame_s) <= 0:
        return None
    return 100.0 * (1.0 - sum(t.busy_in_frame_s) / sum(t.frame_s))

"""What the wrappers of the hand-written CUDA kernels share: their launch
counts and the route from a tensor's device to a kernel or a plain version.

A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises (`route`). Each kernel launch
adds one to `launch_counts[name]`, so a run can show that its main path
went through the kernels; inside a CUDA graph (`graphs.graphed`) the
launches recorded at the capture are added at each replay instead, and to
`replay_counts[name]` too: the launches that came from graph replays.

The kernels: the frontend's `fast9`, `lk_level` and `lk_track`
(`frontend/kernels.py`) and the filter's `uwb_update` (`update/uwb.py`)
and `slam_init` (`update/slam.py` `slam_delayed_init`).
"""

from __future__ import annotations

launch_counts = {"fast9": 0, "lk_level": 0, "lk_track": 0, "uwb_update": 0, "slam_init": 0}
replay_counts = dict(launch_counts)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = replay_counts[k] = 0


def route(*tensors) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")

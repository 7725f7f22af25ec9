"""Process CPU/RAM recorder: port of `uvio_tpu/eval/proc_monitor.py`
(`ov_eval/python/pid_sys.py` equivalent, ROS-free).

Samples CPU percent and resident memory of one or more processes
(matched by PID or by name/cmdline substring) at a fixed rate and
writes a CSV `time,pid,cpu_percent,mem_mb`. Used to record estimator
resource usage alongside the per-stage timing CSV.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional


def find_processes(name: str) -> List[int]:
    """PIDs whose process name, exe basename, or argv[0] matches
    `name` (the pid_sys.py lookup semantics)."""
    import psutil

    pids = []
    for proc in psutil.process_iter():
        try:
            pname = proc.name()
            cmdline = proc.cmdline()
            exe = proc.exe()
        except Exception:
            continue
        cand = [pname, os.path.basename(exe) if exe else ""]
        if cmdline:
            cand.append(os.path.basename(cmdline[0]))
        if name in cand:
            pids.append(proc.pid)
    return pids


def monitor(
    target,
    out_csv: str,
    hz: float = 2.0,
    duration: Optional[float] = None,
    stop_when_gone: bool = True,
):
    """Sample until `duration` elapses or every target process exits.

    target: int PID, list of PIDs, or a process-name string.
    Returns the number of samples written.
    """
    import psutil

    if isinstance(target, str):
        pids = find_processes(target)
        if not pids:
            raise ValueError(f"no process found matching {target!r}")
    elif isinstance(target, int):
        pids = [target]
    else:
        pids = list(target)
    procs = [psutil.Process(p) for p in pids]
    for p in procs:
        p.cpu_percent(None)  # prime the interval counter

    n = 0
    t0 = time.time()
    with open(out_csv, "w") as f:
        f.write("# time(s),pid,cpu_percent,mem_mb\n")
        while True:
            time.sleep(1.0 / hz)
            now = time.time() - t0
            alive = False
            for p in procs:
                try:
                    cpu = p.cpu_percent(None)
                    mem = p.memory_info().rss / 1e6
                except Exception:
                    continue
                alive = True
                f.write(f"{now:.3f},{p.pid},{cpu:.1f},{mem:.1f}\n")
                n += 1
            if duration is not None and now >= duration:
                break
            if stop_when_gone and not alive:
                break
    return n


def load_monitor_csv(path: str):
    """Parse a monitor CSV -> dict pid -> (t, cpu%, mem_mb) arrays."""
    import numpy as np

    rows = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
    out = {}
    if rows.size == 0:
        return out
    for pid in np.unique(rows[:, 1]).astype(int):
        sel = rows[:, 1] == pid
        out[pid] = (rows[sel, 0], rows[sel, 2], rows[sel, 3])
    return out

"""One run of one cell: set up, warm up, an open loop at the sensors'
rates for the window, then the check against the reference and the
metrics.

Everything that belongs to a cell is found by name, so a cell, a mix, a
configuration or a metric is added by adding files:

  cells/<workload>.json    {"config": ..., "traffic": ...}
  configs/<config>.json    the deployment (and configs/<estimator>/ YAML)
  mixes/<traffic>.json     the traffic's parameters (traffic/generate.py)
  metrics/<metric>.py      `read(run)` -> the metric's value, or None

and `BENCHMARK.json` (at the checkout's root) says which metrics a cell
reports: with `--trace 0` its end-to-end metrics, with `--trace 1` its
per-layer ones.

The loop is open: every IMU sample, range set and frame is due at its
sensor time after the window's origin (the last warm-up frame), and is
fed when due, or at once when the host is behind. A frame's pose latency
runs from its due time until `feed_features` returns, which is when its
pose is in host memory (the frame's one read-back).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from typing import List, Optional

import torch

from . import check
from .drivers.vio import Estimator
from .trace import TRACED_FRAMES, Tracer, summarize
from .traffic.generate import make_traffic

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "uvio_tpu")
PROGRAM = "uvio_tpu_torch"


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(name: str, bench_dir: str = BENCH_DIR):
    """(cell, config, mix) of the workload `name`."""
    cell = load_json(bench_dir, "cells", f"{name}.json")
    return (cell, load_json(bench_dir, "configs", f"{cell['config']}.json"),
            load_json(bench_dir, "mixes", f"{cell['traffic']}.json"))


def cell_metrics(manifest: dict, name: str, trace: bool) -> List[dict]:
    """The metrics the workload reports: its end-to-end ones, or with a
    trace the per-layer ones that list it (or, listing no workloads,
    move one of its end-to-end metrics)."""
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """`read` of metrics/<metric>.py."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_package():
    """The port, with only the modules the cell drives."""
    for m in ("utils.config", "manager", "uwb_manager"):
        importlib.import_module(f"{PROGRAM}.{m}")
    return importlib.import_module(PROGRAM)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def wait_until(t: float):
    """Spin until `t` (host clock): a sleeping core is slower to wake and
    clocks down, which spreads the host's part of every frame."""
    while time.perf_counter() < t:
        pass


class Run:
    """What a run measured, for the metric readers.

    frames: one dict per frame due in the window: `k`, `due` and `done`
    (host clock, s), `latency_s`, `build_s`/`step_s`/`post_s` (the
    manager's `last_timing`: host bundle build, step from dispatch to the
    frame's read-back, host bookkeeping), `traced`."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, process_start: float,
             bench_dir: str = BENCH_DIR, root: Optional[str] = None, frames: Optional[int] = None,
             program=None, warmup_s: Optional[float] = None) -> dict:
    """One run; returns the result line as a dict. `frames` (a window of
    that many frames), `warmup_s` (in the mix's place) and `program` (a
    package in the port's place) are for tests."""
    root = root or os.path.dirname(bench_dir)
    manifest = load_json(root, "BENCHMARK.json")
    cell, config, mix = cell_files(name, bench_dir)
    if warmup_s is not None:
        mix = dict(mix, warmup_s=warmup_s)
    metrics = cell_metrics(manifest, name, trace)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    pkg = program or program_package()

    traffic = make_traffic(config, mix, seed, seconds, bench_dir, frames=frames)
    est = Estimator(pkg, config, traffic, bench_dir, device)
    n0, nw = traffic.n_warmup, traffic.n_window
    events = traffic.stream.events
    est.initialize()
    pos = 0
    for pos, (kind, i) in enumerate(events):  # warm-up, as fast as it goes
        getattr(est, f"feed_{kind if kind != 'cam' else 'frame'}")(i)
        if kind == "cam":
            est.record(i)
            if i == n0 - 1:
                break
    if trace:
        Tracer.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the set-up's objects (the stream, the frames' tables) go to the
    # permanent generation, so the collector's full passes in the window
    # walk only what the program allocates
    gc.collect()
    gc.freeze()
    # from here every event is fed at its due time, after the window's
    # origin: the last warm-up frame
    t_origin = float(traffic.stream.cam_t[n0 - 1])
    T0 = time.perf_counter()
    graphs0 = est.graph_count()

    tracer, trace_data = None, None
    trace_start_s = trace_stop_s = 0.0
    setup_s = T0 - process_start
    trace_from = n0 + nw // 2
    rows, timing, failed = [], [], 0
    span = (lambda n: tracer.span(n)) if trace else None
    try:
        for kind, i in events[pos + 1:]:
            if kind == "cam" and i >= n0 + nw:
                break
            due = T0 + (float(getattr(traffic.stream, "cam_t" if kind == "cam" else f"{kind}_t")[i]) - t_origin)
            wait_until(due)
            traced = tracer is not None
            if kind != "cam":
                if traced:
                    with span(f"feed_{kind}"):
                        getattr(est, f"feed_{kind}")(i)
                else:
                    getattr(est, f"feed_{kind}")(i)
                continue
            if traced:
                with span("frame"):
                    est.feed_frame(i)
            else:
                est.feed_frame(i)
            done = time.perf_counter()
            lt = est.mgr.last_timing
            rows.append({"k": i, "due": due, "done": done, "latency_s": done - due, "build_s": lt["uwb"],
                         "step_s": lt["propagation"], "post_s": lt["marginalization"], "traced": traced})
            timing.append(rows[-1] if traced else None)
            est.record(i)
            if trace and i == trace_from - 1:  # in the idle time before the traced frames
                tracer = Tracer()
                tracer.start()
            if tracer is not None and i == trace_from + TRACED_FRAMES - 1:
                tracer.stop()
                trace_start_s, trace_stop_s = tracer.start_s, tracer.stop_s
                trace_data = summarize(tracer, [t for t in timing if t is not None])
                tracer = None
    except Exception:  # the program failed: every frame left in the window has no pose
        traceback.print_exc(file=sys.stderr)
        failed = nw - len(rows)
    end = time.perf_counter()
    for k in range(len(rows), nw):
        due = T0 + (float(traffic.stream.cam_t[n0 + k]) - t_origin)
        rows.append({"k": n0 + k, "due": due, "done": None, "latency_s": max(end - due, 0.0), "build_s": math.nan,
                     "step_s": math.nan, "post_s": math.nan, "traced": False})
    if tracer is not None:
        tracer.stop()
        trace_data = summarize(tracer, [t for t in timing if t is not None])
    graphs1 = est.graph_count()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        memory_peak = int(torch.cuda.max_memory_allocated(device))
        kind_name = torch.cuda.get_device_name(device)
    else:
        memory_peak, kind_name = 0, "cpu"
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of the JAX package or of JAX are loaded: {', '.join(bad)}")

    # the check, once the program's state is freed
    n_frames = n0 + nw - failed
    out = est.outputs(n_frames) if n_frames > 0 else None
    del est
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = {}
    if out is not None:
        try:
            checks = check.judge(config, traffic, out, bench_dir)
        except Exception:  # the reference could not follow the run: nothing is judged correct
            traceback.print_exc(file=sys.stderr)
            checks = {k: (math.inf, lim) for k, lim in config["limits"].items()}
    print(f"port_bench: set-up {setup_s:.1f} s, window {end - T0:.1f} s, check {time.perf_counter() - t_check:.1f} s"
          + (f", profiler start {trace_start_s:.3f} s, stop {trace_stop_s:.3f} s" if trace else ""), file=sys.stderr)
    correct = failed == 0 and bool(checks) and check.passed(checks)

    run = Run(frames=rows, setup_s=setup_s, captures=graphs1 - graphs0,
              trace=trace_data)
    values = {}
    for m in metrics:
        v = reader(m["name"], bench_dir)(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind_name, "count": 1,
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": nw, "failed": failed, "metrics": values, "device": dev}
    if trace and trace_data is not None:
        dev["busy_s"] = trace_data.busy_s
        dev["window_s"] = trace_data.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in trace_data.device_ops],
                               "idle_gaps": trace_data.idle_gaps}
    result["checks"] = {k: {"value": _num(v), "limit": lim} for k, (v, lim) in checks.items()}
    return result


def _num(v):
    return v if math.isfinite(v) else str(v)

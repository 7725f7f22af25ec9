"""One run of one cell: set up, warm up, an open loop at the sensors'
rates for the window, then the check against the reference and the
metrics.

Everything that belongs to a cell is found by name, so a cell, a mix, a
configuration, a metric or a system is added by adding files:

  cells/<workload>.json    {"config": ..., "traffic": ...}
  configs/<config>.json    the deployment: its `system`, its `limits`
                           ({number: limit} of its judge) and what its
                           driver reads (for `vio`, configs/<estimator>/ YAML)
  mixes/<traffic>.json     the traffic's parameters, read by the driver's
                           `make_traffic`
  metrics/<metric>.py      `read(run)` -> the metric's value, or None
  drivers/<system>.py      what runs a configuration of that system

and `BENCHMARK.json` (at the checkout's root) says which metrics a cell
reports: with `--trace 0` its end-to-end metrics, with `--trace 1` its
per-layer ones.

A driver module provides this, and the harness and `readings.py` use
nothing else of it or of what it returns:

  MODULES        the port's submodules it drives: `program_package`
                 imports these (and no module of JAX or of the JAX package
                 may be loaded once the run is judged, whatever the system)
  MIX_KEYS       the keys every mix of its cells holds; a run of a cell
                 whose mix lacks one fails before it starts
  STAGES         ((key, name), ...): the frame's host stages in order from
                 its start, keys of `frame_timing`; a traced run names an
                 idle gap inside a frame by the stage it falls in
  make_traffic(config, mix, seed, seconds, root, frames=None)
                 every input of a run, from the seed: `.stream.events`,
                 (kind, i) in feed order, kind "cam" a frame;
                 `.stream.cam_t` and `.stream.<kind>_t`, each event's
                 sensor time (s); `.n_warmup`, the frames fed as fast as
                 they go (at least one), and `.n_window`, the frames due in
                 the window (`seconds` of them, or `frames`)
  Estimator(pkg, config, traffic, root, device)
                 `initialize()`; `feed_<kind>(i)` for each kind but "cam";
                 `feed_frame(k)`, which returns once frame k's pose is in
                 host memory; `frame_timing()`, the host timings (s) of the
                 frame just fed by name, each a key of its window row;
                 `record(k)` after frame k; `outputs(n)`, what the judge
                 reads of the first n frames, with `.rows`, one a frame;
                 `graph_count()`, CUDA graphs captured so far
  judge(config, traffic, outputs, root)
                 {number: (value, limit)}, a limit for each of the
                 configuration's `limits`; `check.passed` decides `correct`
  control_outputs(pkg, config, traffic, root, device, n)
                 for `readings.py`: the control's outputs of the first n
                 frames, in the program's place

The loop is open: every event is due at its sensor time after the
window's origin (the last warm-up frame), and is fed when due, or at once
when the host is behind. A frame's pose latency runs from its due time
until `feed_frame` returns, which is when its pose is in host memory.
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

from .check import passed
from .trace import TRACED_FRAMES, Tracer, summarize

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


def driver(system: str, bench_dir: str = BENCH_DIR):
    """drivers/<system>.py under `bench_dir`. It is a module of this
    package, so its relative imports resolve here; one in another
    directory (a test's copy of the benchmark) is loaded from its file."""
    name = f"{__package__}.drivers.{system}"
    if os.path.abspath(bench_dir) == BENCH_DIR:
        return importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(name, os.path.join(bench_dir, "drivers", f"{system}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_driver(config: dict, mix: dict, bench_dir: str = BENCH_DIR):
    """The driver of the configuration's `system`, once the mix holds
    every key the driver names in `MIX_KEYS`."""
    drv = driver(config["system"], bench_dir)
    missing = [k for k in drv.MIX_KEYS if k not in mix]
    if missing:
        raise KeyError(f"the mix lacks {', '.join(missing)}, which system {config['system']} reads")
    return drv


def program_package(modules=()):
    """The port, with only the modules the cell drives (its driver's
    `MODULES`)."""
    for m in modules:
        importlib.import_module(f"{PROGRAM}.{m}")
    return importlib.import_module(PROGRAM)


def feed(est, kind: str, i: int):
    """Event `i` of `kind` into the estimator: `feed_frame` for a frame,
    `feed_<kind>` else."""
    getattr(est, "feed_frame" if kind == "cam" else f"feed_{kind}")(i)


def run_events(est, events, n_frames: int) -> int:
    """Initialize the estimator and feed `events` as fast as they go
    through frame `n_frames - 1`, recording each frame; returns the place
    in `events` of the last event fed."""
    est.initialize()
    pos = 0
    for pos, (kind, i) in enumerate(events):
        feed(est, kind, i)
        if kind == "cam":
            est.record(i)
            if i == n_frames - 1:
                break
    return pos


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
    (host clock, s), `latency_s`, each key of the driver's
    `frame_timing()` (for `vio`: `build_s`/`step_s`/`post_s`, the
    manager's host bundle build, step from dispatch to the frame's
    read-back, host bookkeeping; NaN for a frame with no pose), `traced`."""

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
    drv = cell_driver(config, mix, bench_dir)
    if warmup_s is not None:
        mix = dict(mix, warmup_s=warmup_s)
    metrics = cell_metrics(manifest, name, trace)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    pkg = program or program_package(drv.MODULES)

    traffic = drv.make_traffic(config, mix, seed, seconds, bench_dir, frames=frames)
    est = drv.Estimator(pkg, config, traffic, bench_dir, device)
    n0, nw = traffic.n_warmup, traffic.n_window
    events = traffic.stream.events
    pos = run_events(est, events, n0)  # warm-up, as fast as it goes
    no_pose = dict.fromkeys(est.frame_timing(), math.nan)
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
                        feed(est, kind, i)
                else:
                    feed(est, kind, i)
                continue
            if traced:
                with span("frame"):
                    est.feed_frame(i)
            else:
                est.feed_frame(i)
            done = time.perf_counter()
            rows.append({"k": i, "due": due, "done": done, "latency_s": done - due, **est.frame_timing(),
                         "traced": traced})
            timing.append(rows[-1] if traced else None)
            est.record(i)
            if trace and i == trace_from - 1:  # in the idle time before the traced frames
                tracer = Tracer()
                tracer.start()
            if tracer is not None and i == trace_from + TRACED_FRAMES - 1:
                tracer.stop()
                trace_start_s, trace_stop_s = tracer.start_s, tracer.stop_s
                trace_data = summarize(tracer, [t for t in timing if t is not None], drv.STAGES)
                tracer = None
    except Exception:  # the program failed: every frame left in the window has no pose
        traceback.print_exc(file=sys.stderr)
        failed = nw - len(rows)
    end = time.perf_counter()
    for k in range(len(rows), nw):
        due = T0 + (float(traffic.stream.cam_t[n0 + k]) - t_origin)
        rows.append({"k": n0 + k, "due": due, "done": None, "latency_s": max(end - due, 0.0), **no_pose,
                     "traced": False})
    if tracer is not None:
        tracer.stop()
        trace_data = summarize(tracer, [t for t in timing if t is not None], drv.STAGES)
    graphs1 = est.graph_count()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        memory_peak = int(torch.cuda.max_memory_allocated(device))
        kind_name = torch.cuda.get_device_name(device)
    else:
        memory_peak, kind_name = 0, "cpu"

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
            checks = drv.judge(config, traffic, out, bench_dir)
        except Exception:  # the reference could not follow the run: nothing is judged correct
            traceback.print_exc(file=sys.stderr)
            checks = {k: (math.inf, lim) for k, lim in config["limits"].items()}
    print(f"port_bench: set-up {setup_s:.1f} s, window {end - T0:.1f} s, check {time.perf_counter() - t_check:.1f} s"
          + (f", profiler start {trace_start_s:.3f} s, stop {trace_stop_s:.3f} s" if trace else ""), file=sys.stderr)
    correct = failed == 0 and bool(checks) and passed(checks)

    run = Run(frames=rows, setup_s=setup_s, captures=graphs1 - graphs0,
              trace=trace_data)
    values = {}
    for m in metrics:
        v = reader(m["name"], bench_dir)(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    # last, once the judge and the readers have loaded what they need
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of the JAX package or of JAX are loaded: {', '.join(bad)}")
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

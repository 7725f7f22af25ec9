#!/usr/bin/env python3
"""Where a live frame's time goes, from the program's own spans: one run of
a `port_bench` cell with `uvio_tpu_torch`'s tracing switch set, every
window frame's `last_timing` row kept beside its due time.

    python3 scripts/frame_spans.py --workload uwb_corridor.live --seed 7 \\
        --seconds 20 --on 1 [--trace 1] [--no-check] [--rows FILE]

`--on 1` turns `uvio_tpu_torch.tracing` on before the manager is built
(host spans as `uvio/` ranges, device marks in the fused graph); `--on 0`
leaves it off, for an on/off comparison through the same wrappers.
`--trace 1` runs the cell's profiler stretch and keeps the `uvio/` host
ranges in it (their device-side copies are dropped, as the harness drops
its own spans'), so every idle gap inside a frame is named by the
innermost program span that holds it. The harness files are used as they
are: this script wraps `port_bench`'s `wait_until`, `Estimator.feed_frame`
and `Tracer` from outside.

Prints the run's result line, then one JSON line of the frames' spans
over the window's frames outside the profiler stretch and the stall after
it (`Tracer.stop` and the trace's summary run inside the window loop, and
the frames due meanwhile queue behind them: a frame is left out from the
stretch's start until one is due after the summary returned and after
the frame before it was done). In a `--trace 1` run the frames before the
stretch still run under the profiler's warm-up in set-up, whose CUDA
callbacks stay registered, so its host spans of the step read higher than
a `--trace 0` run's (PERF.md §7). The line holds `ingest_ms`,
`frame_wait_p95_ms` (`t_start` - due), `step_host_ms` (plan + pack),
`readback_ms`, `build_ms`, `post_ms`, `step_graph_ms` (median of the
replay events) and `step_graph_p95_ms`, the mean device ms of each graph
stage, `residual_ms` (median of latency - (wait + ingest + build + step
+ post)), the same per 4 s of window, and for a traced run the `frame`
and `uvio/frame` ranges the profiler kept and the frames left out. `--rows` writes every window
frame's row as JSON lines.

A cell whose estimator has a KLT tracker (`--workload euroc_v101.klt_live`)
keeps the tracker's row beside the manager's (`tracker`), and the line
gains `tracker`: the means of its spans (`track_ms`, `upload_ms`,
`replay_ms`, `readback_ms`, `spawn_ms`) and of the frame's conversion to
float32 (`convert_ms`, from the driver's timing), the median of its
graph's replay events (`graph_ms`), the mean device ms of each of its
marks (`preprocess`, `lk`, `ransac`, `detect`, `outputs`), its counts a
frame (`n_tracked`, `n_lk_lost`, `n_ransac_lost`, `n_spawned`) and
`residual_ms` less the tracker and the conversion (`frame_residual_ms`).
Every cell's line also counts, over the window's frames, the SLAM
delayed-init kernel's launches (`launches.launch_counts`) against the
frames whose plan had candidates (`slam_cands` in the manager's row), and
the MSCKF update kernel's launches against the frames with MSCKF features
(`msckf_feats`; the fused step runs the update on every frame, so a frame
without features would count as a launch off).
"""

import argparse
import json
import os
import statistics
import sys
import time

PROCESS_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("unpack", "uwb_drain", "propagate_clone", "msckf", "slam", "marginalize", "zupt", "outputs")
TRACKER_STAGES = ("preprocess", "lk", "ransac", "detect", "outputs")
TRACKER_COUNTS = ("n_tracked", "n_lk_lost", "n_ransac_lost", "n_spawned")
SLICE_S = 4.0


class _Spans(tuple):
    """The harness's span names, and every program range (`uvio/...`)."""

    def __contains__(self, name):
        return name.startswith("uvio/") or tuple.__contains__(self, name)


def summarize(rows, run_start):
    def mean(v):
        return statistics.fmean(v) if v else None

    def p95(v):
        return statistics.quantiles(v, n=20, method="inclusive")[-1] if len(v) > 1 else None

    ms = lambda r, *keys: 1e3 * sum(r["spans"][k] for k in keys)  # noqa: E731
    out = {"frames": len(rows),
           "ingest_ms": mean([ms(r, "ingest") for r in rows]),
           "frame_wait_p95_ms": p95([1e3 * (r["spans"]["t_start"] - r["due"]) for r in rows]),
           "step_host_ms": mean([ms(r, "plan", "pack") for r in rows]),
           "readback_ms": mean([ms(r, "readback") for r in rows]),
           "build_ms": mean([ms(r, "build") for r in rows]),
           "post_ms": mean([ms(r, "post") for r in rows]),
           "step_ms": mean([ms(r, "step") for r in rows]),
           "host_ms": mean([ms(r, "uwb", "marginalization") for r in rows]),
           "residual_ms": statistics.median(
               [1e3 * (r["done"] - r["spans"]["t_start"]) - ms(r, "ingest", "build", "step", "post")
                for r in rows]) if rows else None}
    dev = [r["spans"]["device"] for r in rows if "device" in r["spans"]]
    graph = [d["graph"] for d in dev]
    out["step_graph_ms"] = statistics.median(graph) if graph else None
    out["step_graph_p95_ms"] = p95(graph)
    out["stage_ms"] = {s: mean([d[s] for d in dev if s in d]) for s in STAGES}
    out["stages_over_graph"] = mean([sum(v for k, v in d.items() if k != "graph") / d["graph"] for d in dev])
    slices = {}
    for r in rows:
        slices.setdefault(int((r["due"] - run_start) // SLICE_S), []).append(r)
    out["per_4s"] = [{"from_s": k * SLICE_S,
                      "step_graph_ms": statistics.median(g) if (g := [r["spans"]["device"]["graph"]
                                                                   for r in v if "device" in r["spans"]]) else None,
                      "step_host_ms": mean([ms(r, "plan", "pack") for r in v]),
                      "latency_ms": statistics.median([1e3 * (r["done"] - r["due"]) for r in v])}
                     for k, v in sorted(slices.items())]
    tracked = [r for r in rows if "tracker" in r]
    if tracked:
        tms = lambda r, k: 1e3 * r["tracker"][k]  # noqa: E731
        tdev = [r["tracker"]["device"] for r in tracked if "device" in r["tracker"]]
        tgraph = [d["graph"] for d in tdev]
        out["tracker"] = {
            **{f"{k}_ms": mean([tms(r, k) for r in tracked]) for k in ("track", "upload", "replay", "readback", "spawn")},
            "convert_ms": mean([1e3 * r["convert_s"] for r in tracked]),
            "graph_ms": statistics.median(tgraph) if tgraph else None,
            "graph_p95_ms": p95(tgraph),
            "stage_ms": {s: mean([d[s] for d in tdev if s in d]) for s in TRACKER_STAGES},
            "counts": {k: mean([r["tracker"][k] for r in tracked]) for k in TRACKER_COUNTS},
            "frame_residual_ms": statistics.median(
                [1e3 * (r["done"] - r["spans"]["t_start"]) - ms(r, "ingest", "build", "step", "post")
                 + 1e3 * (r["spans"]["t_start"] - r["tracker"]["t_start"]) - tms(r, "track") for r in tracked]),
            "slam": {k: mean([r["spans"][k] for r in tracked if k in r["spans"]]) for k in
                     ("slam_in_state", "slam_updated", "slam_cands", "slam_inited", "slam_marginalized")}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="uwb_corridor.live")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--on", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--no-check", action="store_true", help="skip the reference's check after the window")
    ap.add_argument("--rows", help="write the window frames' rows here, one JSON line each")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("frame_spans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from port_bench import check, check_klt, harness, trace
    from uvio_tpu_torch import launches, tracing

    Estimator = harness.driver(harness.cell_files(args.workload)[1]["system"]).Estimator

    tracing.enable(bool(args.on))
    state = {"due": None, "profiling": False, "ranges": None, "summary_done": None}
    rows = []

    wait_until = harness.wait_until

    def waiting(t):
        state["due"] = t
        wait_until(t)

    feed_frame = Estimator.feed_frame

    def feeding(est, k):
        due, state["due"] = state["due"], None
        inits = launches.launch_counts.get("slam_init", 0)
        updates = launches.launch_counts.get("msckf_update", 0)
        feed_frame(est, k)
        done = time.perf_counter()
        if due is not None:
            rows.append({"k": k, "due": due, "done": done, "traced": state["profiling"],
                         "spans": dict(est.mgr.last_timing),
                         "slam_init_launches": launches.launch_counts.get("slam_init", 0) - inits,
                         "msckf_update_launches": launches.launch_counts.get("msckf_update", 0) - updates})
            if hasattr(est, "tracker"):
                rows[-1]["tracker"] = dict(est.tracker.last_timing)
                rows[-1]["convert_s"] = est.frame_timing()["convert_s"]

    start, stop = trace.Tracer.start, trace.Tracer.stop

    def starting(tr):
        start(tr)
        state["profiling"] = True

    def stopping(tr):
        stop(tr)
        state["profiling"] = False
        host = [n for n, on_dev, _, _ in tr.events if not on_dev]
        state["ranges"] = {"frame": host.count("frame"), "uvio/frame": host.count("uvio/frame"),
                           "of": trace.TRACED_FRAMES}

    summarize_trace = harness.summarize

    def summarizing(*a, **k):
        out = summarize_trace(*a, **k)
        state["summary_done"] = time.perf_counter()
        return out

    harness.summarize = summarizing
    harness.wait_until = waiting
    Estimator.feed_frame = feeding
    trace.Tracer.start, trace.Tracer.stop = starting, stopping
    trace.SPANS = _Spans(trace.SPANS)
    if args.no_check:
        check.judge = check_klt.judge = lambda *a, **k: {}

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", PROCESS_START)
    result.pop("checks", None)
    print(json.dumps(result), flush=True)
    window, stalled, prev_done = [], False, None
    for r in rows:
        stalled = r["traced"] or stalled and (
            state["summary_done"] is None or r["due"] < state["summary_done"] or prev_done > r["due"])
        if not stalled:
            window.append(r)
        prev_done = r["done"]
    summary = summarize(window, rows[0]["due"] if rows else 0.0)
    summary["slam_init"] = {  # the kernel's launches against the frames with candidates
        "launches": sum(r["slam_init_launches"] for r in window),
        "frames_with_candidates": sum(r["spans"].get("slam_cands", 0) > 0 for r in window),
        "frames_not_one_launch_a_plan": sum(r["slam_init_launches"] != (r["spans"].get("slam_cands", 0) > 0)
                                            for r in window)}
    summary["msckf_update"] = {  # the kernel's launches against the frames with features
        "launches": sum(r["msckf_update_launches"] for r in window),
        "frames_with_features": sum(r["spans"].get("msckf_feats", 0) > 0 for r in window),
        "features": statistics.fmean([r["spans"].get("msckf_feats", 0) for r in window]) if window else None,
        "frames_not_one_launch_a_frame_with_features": sum(
            r["msckf_update_launches"] != (r["spans"].get("msckf_feats", 0) > 0) for r in window)}
    summary.update(on=args.on, trace=args.trace, seed=args.seed, ranges=state["ranges"],
                   left_out=len(rows) - len(window), card=torch.cuda.get_device_name(0))
    print(json.dumps(summary), flush=True)
    if args.rows:
        with open(args.rows, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

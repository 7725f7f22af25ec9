"""Per-stage timing analysis.

Port of `uvio_tpu/eval/timing.py`, the equivalent of the reference's timing toolchain: the estimator records a
per-frame CSV of stage wall-times (`VioManager.cpp:117-121,631-644`;
`VioManager.record_timing` here), and `ov_eval` ships four consumers
(`ov_eval/cmake/ROS1.cmake:155-183`):

  * `timing_histogram`   — distribution of one column
  * `timing_comparison`  — total-time stats across runs
  * `timing_percentages` — mean share of each stage in the total
  * `timing_flamegraph`  — cumulative per-stage timeline

All are reimplemented on numpy; the "plots" are rendered as text
(terminal-friendly) with the same statistics the reference plots.
"""

from __future__ import annotations

import numpy as np


def load_timing_csv(path):
    """Load a timing CSV -> (names, t, data[N, S]).

    First column is the frame timestamp; remaining columns are stage
    seconds; a trailing 'total' column is expected (the reference's
    format: tracking, propagation, msckf, slam, marg, total).
    """
    with open(path) as f:
        header = f.readline().strip().lstrip("#").strip()
    names = [c.strip() for c in header.split(",")]
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return names[1:], data[:, 0], data[:, 1:]


def stats(x):
    x = np.asarray(x, float)
    if x.size == 0:
        return dict(mean=0.0, std=0.0, median=0.0, p95=0.0, p99=0.0, max=0.0)
    return dict(
        mean=float(np.mean(x)),
        std=float(np.std(x)),
        median=float(np.median(x)),
        p95=float(np.percentile(x, 95)),
        p99=float(np.percentile(x, 99)),
        max=float(np.max(x)),
    )


def _text_hist(x, bins=20, width=50):
    counts, edges = np.histogram(x, bins=bins)
    peak = max(1, counts.max())
    lines = []
    for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * int(round(width * c / peak))
        lines.append(f"  [{lo * 1e3:8.3f}, {hi * 1e3:8.3f}) ms |{bar} {c}")
    return "\n".join(lines)


def timing_histogram(path, column="total", bins=20):
    names, _, data = load_timing_csv(path)
    if column not in names:
        raise ValueError(f"column {column!r} not in {names}")
    x = data[:, names.index(column)]
    s = stats(x)
    out = [
        f"[timing_histogram] {path} column={column} frames={len(x)}",
        (
            f"  mean = {s['mean'] * 1e3:.3f} ms | std = {s['std'] * 1e3:.3f}"
            f" | median = {s['median'] * 1e3:.3f} | p95 = {s['p95'] * 1e3:.3f}"
            f" | p99 = {s['p99'] * 1e3:.3f} | max = {s['max'] * 1e3:.3f}"
        ),
        _text_hist(x, bins=bins),
    ]
    return "\n".join(out)


def timing_comparison(paths):
    out = ["[timing_comparison]"]
    for path in paths:
        names, _, data = load_timing_csv(path)
        col = names.index("total") if "total" in names else -1
        s = stats(data[:, col])
        fps = 1.0 / s["mean"] if s["mean"] > 0 else float("inf")
        out.append(
            f"  {path}: mean = {s['mean'] * 1e3:.3f} ms ({fps:.1f} fps) | "
            f"std = {s['std'] * 1e3:.3f} | p99 = {s['p99'] * 1e3:.3f} | "
            f"max = {s['max'] * 1e3:.3f}"
        )
    return "\n".join(out)


def timing_percentages(path):
    names, _, data = load_timing_csv(path)
    if "total" in names:
        tot_idx = names.index("total")
    else:
        tot_idx = None
    total = data[:, tot_idx] if tot_idx is not None else data.sum(1)
    total = np.where(total <= 0, np.nan, total)
    out = [f"[timing_percentages] {path} frames={data.shape[0]}"]
    for i, n in enumerate(names):
        if i == tot_idx:
            continue
        pct = np.nanmean(data[:, i] / total) * 100.0
        out.append(
            f"  {n:12s}: {pct:5.1f} %  (mean {np.mean(data[:, i]) * 1e3:7.3f} ms)"
        )
    out.append(f"  {'total':12s}: 100.0 %  (mean {np.nanmean(total) * 1e3:7.3f} ms)")
    return "\n".join(out)


def timing_flamegraph(path, width=60):
    """Cumulative stacked per-stage time shares, rendered as text bars
    (the reference plots a stacked 'flamegraph' over time)."""
    names, _, data = load_timing_csv(path)
    tot_idx = names.index("total") if "total" in names else None
    stage_idx = [i for i in range(len(names)) if i != tot_idx]
    cum = data[:, stage_idx].sum(0)
    total = cum.sum()
    out = [f"[timing_flamegraph] {path} cumulative = {total:.3f} s"]
    for i, si in enumerate(stage_idx):
        frac = cum[i] / total if total > 0 else 0.0
        bar = "#" * int(round(width * frac))
        out.append(f"  {names[si]:12s} |{bar:<{width}}| {cum[i]:8.3f} s ({frac * 100:4.1f}%)")
    return "\n".join(out)

"""Evaluation CLI: the 12 `ov_eval` binaries as one tool (port of
`uvio_tpu/eval/cli.py`, the same subcommands and the same output).

Subcommands mirror the reference's executables
(`ov_eval/cmake/ROS1.cmake:90-187`):

    error_singlerun  <align> <est.txt> <gt.txt>        ATE + RPE table
    error_dataset    <align> <gt.txt> <est1> [est2..]  Monte-Carlo stats
    error_comparison <align> <gt.txt> <m1> <m2> ...    method comparison
    error_simulation <est_state> <std> <gt_state>      NEES/3sigma/calib
    timing_histogram   <timing.csv> [column]
    timing_comparison  <timing1.csv> [timing2.csv ...]
    timing_percentages <timing.csv>
    timing_flamegraph  <timing.csv>
    plot_trajectories <align> <gt.txt> <est1> [est2..] stats (+ --save png)
    pose_to_file      <state_est.txt> <out_tum.txt>    state stream -> TUM
    format_converter  <in> <out>                       EuRoC csv/state -> TUM
    live_align_trajectory <align> <est> <gt>           growing-window align

Trajectory files are TUM format `t x y z qx qy qz qw` with JPL q_GtoI,
the format the reference records (`ROS1Visualizer.cpp:117-143`).

Usage: python -m uvio_tpu_torch.eval.cli error_singlerun se3 est.txt gt.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .recorder import load_state_file
from .simres import error_simulation, format_report
from .timing import (
    timing_comparison,
    timing_flamegraph,
    timing_histogram,
    timing_percentages,
)
from .traj import ate, intersect, load_tum, rpe, save_tum, umeyama_align

SEGMENTS = (8, 16, 24, 32, 40)  # error_singlerun.cpp:134
SEGMENTS_DATASET = (7, 14, 21, 28, 35)  # error_dataset.cpp:90


def _print_run(name, est_path, gt_path, align, segments=SEGMENTS):
    t_e, q_e, p_e = load_tum(est_path)
    t_g, q_g, p_g = load_tum(gt_path)
    res = ate(t_e, q_e, p_e, t_g, q_g, p_g, method=align)
    print(f"[{name}] matched poses: {res['n']}  (alignment: {align})")
    print(
        f"  ATE: rmse_pos = {res['rmse_pos']:.4f} m | rmse_ori = "
        f"{res['rmse_ori_deg']:.4f} deg | mean_pos = {res['mean_pos']:.4f} m"
    )
    r = rpe(t_e, q_e, p_e, t_g, q_g, p_g, segment_lengths=segments)
    for L, v in r.items():
        print(
            f"  RPE {L:3d} m: rmse_pos = {v['rmse_pos']:.4f} m | "
            f"rmse_ori = {v['rmse_ori_deg']:.4f} deg | n = {v['n']}"
        )
    return res


def _load_any(path):
    """Load TUM or state-stream file -> (t, q, p)."""
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#"):
                ncol = len(s.replace(",", " ").split())
                break
        else:
            raise ValueError(f"{path}: empty")
    if ncol >= 17:  # state stream: t q(4) p(3) v bg ba ...
        t, q, p = load_state_file(path)[:3]
        return t, q, p
    if ncol == 8:  # TUM: t, p, q(xyzw)
        return load_tum(path)
    raise ValueError(f"{path}: unrecognized trajectory format ({ncol} columns)")


def _convert(inp, out):
    """EuRoC groundtruth csv / state stream / TUM -> TUM
    (`ov_eval/src/format_converter.cpp` behavior)."""
    with open(inp) as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#"):
                break
        else:
            raise ValueError(f"{inp}: empty")
    cols = s.replace(",", " ").split()
    if "," in s and len(cols) >= 8 and float(cols[0]) > 1e14:
        # EuRoC csv: t[ns], p(3), q_wxyz(4), [v, bw, ba]
        data = np.loadtxt(inp, delimiter=",", comments="#", ndmin=2)
        t = data[:, 0] * 1e-9
        p = data[:, 1:4]
        q_wxyz = data[:, 4:8]
        q = np.concatenate([q_wxyz[:, 1:4], q_wxyz[:, 0:1]], axis=1)
    else:
        t, q, p = _load_any(inp)
    save_tum(out, t, q, p)
    print(f"[format_converter] wrote {len(t)} poses -> {out}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="uvio_tpu_torch.eval")
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name in ("error_singlerun",):
        p = sub.add_parser(name)
        p.add_argument("align", choices=["none", "posyaw", "se3", "sim3"])
        p.add_argument("est")
        p.add_argument("gt")

    p = sub.add_parser("error_dataset")
    p.add_argument("align", choices=["none", "posyaw", "se3", "sim3"])
    p.add_argument("gt")
    p.add_argument("runs", nargs="+")

    p = sub.add_parser("error_comparison")
    p.add_argument("align", choices=["none", "posyaw", "se3", "sim3"])
    p.add_argument("gt")
    p.add_argument("methods", nargs="+")

    p = sub.add_parser("error_simulation")
    p.add_argument("est_state")
    p.add_argument("std")
    p.add_argument("gt_state")

    p = sub.add_parser("timing_histogram")
    p.add_argument("csv")
    p.add_argument("column", nargs="?", default="total")

    p = sub.add_parser("timing_comparison")
    p.add_argument("csvs", nargs="+")

    p = sub.add_parser("timing_percentages")
    p.add_argument("csv")

    p = sub.add_parser("timing_flamegraph")
    p.add_argument("csv")

    p = sub.add_parser("plot_trajectories")
    p.add_argument("align", choices=["none", "posyaw", "se3", "sim3"])
    p.add_argument("gt")
    p.add_argument("ests", nargs="+")
    p.add_argument("--save", default=None, help="write a PNG via matplotlib")

    p = sub.add_parser("pose_to_file")
    p.add_argument("state_est")
    p.add_argument("out")

    p = sub.add_parser("format_converter")
    p.add_argument("input")
    p.add_argument("output")

    p = sub.add_parser("live_align_trajectory")
    p.add_argument("align", choices=["none", "posyaw", "se3", "sim3"])
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--chunks", type=int, default=10)

    args = ap.parse_args(argv)

    if args.cmd == "error_singlerun":
        _print_run("singlerun", args.est, args.gt, args.align)
    elif args.cmd == "error_dataset":
        rms = []
        for run in args.runs:
            res = _print_run(run, run, args.gt, args.align, SEGMENTS_DATASET)
            rms.append(res["rmse_pos"])
        print(
            f"[dataset] runs = {len(rms)} | mean rmse = {np.mean(rms):.4f} m "
            f"| std = {np.std(rms):.4f} m"
        )
    elif args.cmd == "error_comparison":
        for m in args.methods:
            _print_run(m, m, args.gt, args.align)
    elif args.cmd == "error_simulation":
        print(format_report(error_simulation(args.est_state, args.std, args.gt_state)))
    elif args.cmd == "timing_histogram":
        print(timing_histogram(args.csv, column=args.column))
    elif args.cmd == "timing_comparison":
        print(timing_comparison(args.csvs))
    elif args.cmd == "timing_percentages":
        print(timing_percentages(args.csv))
    elif args.cmd == "timing_flamegraph":
        print(timing_flamegraph(args.csv))
    elif args.cmd == "plot_trajectories":
        aligned = []
        for est in args.ests:
            res = _print_run(est, est, args.gt, args.align)
            aligned.append((est, res))
        if args.save:
            try:
                import matplotlib

                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                t_g, q_g, p_g = load_tum(args.gt)
                fig, ax = plt.subplots(figsize=(7, 7))
                ax.plot(p_g[:, 0], p_g[:, 1], "k--", label="groundtruth")
                for est in args.ests:
                    t_e, q_e, p_e = load_tum(est)
                    s, R, tr = umeyama_align(p_e, p_g[: len(p_e)], args.align)
                    pa = (s * (R @ p_e.T)).T + tr
                    ax.plot(pa[:, 0], pa[:, 1], label=est)
                ax.set_aspect("equal")
                ax.legend()
                ax.set_xlabel("x (m)")
                ax.set_ylabel("y (m)")
                fig.savefig(args.save, dpi=120)
                print(f"[plot_trajectories] saved {args.save}")
            except ImportError:
                print("[plot_trajectories] matplotlib unavailable; stats only")
    elif args.cmd == "pose_to_file":
        t, q, p = load_state_file(args.state_est)[:3]
        save_tum(args.out, t, q, p)
        print(f"[pose_to_file] wrote {len(t)} poses -> {args.out}")
    elif args.cmd == "format_converter":
        _convert(args.input, args.output)
    elif args.cmd == "live_align_trajectory":
        # growing-window alignment: report how the est->gt alignment
        # drifts as the trajectory extends (live_align_trajectory.cpp
        # behavior, offline).
        t_e, q_e, p_e = _load_any(args.est)
        t_g, q_g, p_g = _load_any(args.gt)
        ie, ig = intersect(t_e, t_g)
        pe, pg = p_e[ie], p_g[ig]
        n = len(pe)
        for k in range(1, args.chunks + 1):
            m = max(3, n * k // args.chunks)
            s, R, tr = umeyama_align(pe[:m], pg[:m], args.align)
            yaw = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
            err = np.sqrt(np.mean(np.sum(((s * (R @ pe[:m].T)).T + tr - pg[:m]) ** 2, 1)))
            print(
                f"  [{m:5d}/{n}] scale = {s:.4f} | yaw = {yaw:7.2f} deg | "
                f"t = [{tr[0]:7.3f} {tr[1]:7.3f} {tr[2]:7.3f}] | rmse = {err:.4f} m"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time one in-motion initializer attempt on one CUDA card, with the
Gauss-Newton steps replayed from a captured CUDA graph (the port's path)
and with every step run eagerly.

    python scripts/time_dynamic_init.py [--iters 10,50] [--out FILE]

Solves the window of tests/test_torch_init_cuda.py (6 poses 0.3 s apart,
15 tracks, 128 IMU samples an interval, float64) with
`solve_dynamic_init` at each Gauss-Newton step count, in the order
graph, eager, eager, graph after one warm-up solve at 10 steps (the
process's first, also timed), each timed on the host clock to its
read-back. Prints one JSON line per step count: the times, and the
largest relative difference of the two routes' params.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", default="10,50")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import dataclasses

    import numpy as np
    import torch

    from test_torch_init_cuda import eager_steps, make_window
    from uvio_tpu_torch.init import dynamic_init as D

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    window = [torch.as_tensor(np.asarray(x), device="cuda:0") for x in make_window()]
    base = D.DynamicInitOptions(max_features=15)
    graph_route = D._gn_on_graph

    def solve(route, opts):
        D._gn_on_graph = route
        try:
            t0 = time.perf_counter()
            out = D.solve_dynamic_init(*window, opts)
            float(out["rmse_norm"])  # the read-back
            return (time.perf_counter() - t0) * 1e3, out
        finally:
            D._gn_on_graph = graph_route

    cold_ms, _ = solve(graph_route, base)  # the process's first use of the solver's kernels
    lines = []
    for n in [int(x) for x in args.iters.split(",")]:
        opts = dataclasses.replace(base, gn_iters=n)
        runs = {"graph": [], "eager": []}
        outs = {}
        for name in ("graph", "eager", "eager", "graph"):
            ms, outs[name] = solve(graph_route if name == "graph" else eager_steps, opts)
            runs[name].append(ms)
        diff = max(float((outs["graph"]["params"][k] - outs["eager"]["params"][k]).abs().max()
                         / outs["eager"]["params"][k].abs().max()) for k in outs["eager"]["params"])
        line = {"gn_iters": n, "graph_ms": runs["graph"], "eager_ms": runs["eager"],
                "max_rel_param_diff": diff, "rmse_norm": float(outs["graph"]["rmse_norm"]), "cold_first_graph_ms_at_10": cold_ms,
                "card": card()}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()

"""The readings a cell's limits are set from: the program's numbers and
its control's, each against the plain reference, on the cell's own
inputs and size, many seeds in one process.

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 --seconds <s> [--side program|control|both]

For each seed it makes the run's traffic, feeds the warm-up's and the
window's frames as fast as they go through the program (`program`) or
through the control in its place (`control`, which the configuration's
driver defines: for `vio` the program in float32, the nearest precision
below the configuration's float64), judges the
outputs as a run judges the program's, and prints one JSON line: the
seed, the side, the frames and each number beside its limit. A sound
check reads `correct: true` for the program and `false` for the
control. The benchmark's own runs never run this; it needs the card.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(name: str, seed: int, seconds: float, device, side: str, frames=None, warmup_s=None) -> dict:
    """One seed's readings of `side`; `frames` and `warmup_s` shrink the
    run for tests."""
    from port_bench.check import passed
    from port_bench.harness import BENCH_DIR, cell_driver, cell_files, program_package, run_events

    _, config, mix = cell_files(name)
    drv = cell_driver(config, mix)
    if warmup_s is not None:
        mix = dict(mix, warmup_s=warmup_s)
    traffic = drv.make_traffic(config, mix, seed, seconds, BENCH_DIR, frames=frames)
    n = traffic.n_warmup + traffic.n_window
    pkg = program_package(drv.MODULES)
    t0 = time.perf_counter()
    if side == "control":
        out = drv.control_outputs(pkg, config, traffic, BENCH_DIR, device, n)
    else:
        est = drv.Estimator(pkg, config, traffic, BENCH_DIR, device)
        run_events(est, traffic.stream.events, n)
        out = est.outputs(n)
        del est
    t1 = time.perf_counter()
    checks = drv.judge(config, traffic, out, BENCH_DIR)
    return {"seed": seed, "side": side, "correct": passed(checks) and len(out.rows) == n,
            "frames": len(out.rows), "of": n, "run_s": t1 - t0, "reference_s": time.perf_counter() - t1,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--side", choices=("program", "control", "both"), default="both")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = ("program", "control") if args.side == "both" else (args.side,)
    for side in sides:
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(reading(args.workload, seed, args.seconds, "cuda:0", side)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

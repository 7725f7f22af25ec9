#!/usr/bin/env python3
"""Time the port's hand-written kernels on one CUDA card, tree against
tree within one run.

    python scripts/compare_kernels.py --parent DIR [--out FILE]

`--parent DIR` measures another checkout (e.g. the parent commit unpacked
by `git archive` into a gitignored directory) and this one in turns:
parent, change, change, parent, each in a process of its own with that
tree's `uvio_tpu_torch` and its own build of its `csrc/`. Per turn: both
clocks of `chip_smoke.py` for every kernel the tree has (`ms`, a CUDA
graph of 100 launches of the C entry point; `wrapper_ms`, a Python loop
over the wrapper), the yardsticks where the tree's library has them, the
image -> pose slice (launch counts, ms per frame over 3 warm repetitions
of the 59 steps), and `torch.profiler` over frames 20-24 of the slice
(launches per frame, device busy time, the hand kernels' device time by
name). The inputs are always made by this checkout's `chip_smoke.py`.

Prints one JSON line per turn and writes them all to `--out`.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return torch.device("cuda:0"), card


def measure_tree(root):
    """One turn: the tree at `root`, in this process."""
    import torch

    sys.path.insert(0, root)
    smoke = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    prof = _load("profile_steps", os.path.join(HERE, "scripts", "profile_steps.py"))
    dev, card = _setup()
    from uvio_tpu_torch import _build
    from uvio_tpu_torch.frontend import kernels as K

    t0 = time.perf_counter()
    _build.build()
    lib = _build.load()
    rec = {"root": root, "card": card, "build_s": time.perf_counter() - t0}
    sim, imgs, stamps, imu = smoke.render(60)
    inp = smoke.kernel_inputs(dev, imgs)
    rec["kernels"] = smoke.time_kernels(lib, K, inp)
    if hasattr(lib, "uvio_empty_launch"):
        rec["yardsticks"] = smoke.time_yardsticks(
            lib, inp["rendered"], {"fast9_grid": (6, 60, 256), "lk_grid": (150, 1, 128)})

    steps = smoke.slice_steps(dev, sim, imgs, stamps, imu)[0]

    def run_slice():
        for st, _ in steps():
            pass
        torch.cuda.synchronize()
        return st

    K.reset_launch_counts()
    st = run_slice()
    rec["launch_counts_59_steps"] = dict(K.launch_counts)
    rec["final_p"] = st.p.cpu().tolist()
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_slice()
        reps.append((time.perf_counter() - t0) / 59 * 1e3)
    rec["slice_ms_per_frame_median"] = statistics.median(reps)
    rec["slice_ms_per_frame_reps"] = reps

    frames = steps()
    for _ in range(prof.WARM):
        next(frames)
    traced = prof.trace(frames, prof.TRACED)
    traced["top_device_ops_ms"] = traced["top_device_ops_ms"][:8]
    rec["profile"] = traced

    def five():
        it = steps()
        for _ in range(5):
            next(it)

    rec["profiled_kernels"] = smoke.profiled_kernel_ms(five)
    return rec


def compare_trees(parent, out):
    recs = []
    for turn, root in enumerate([parent, HERE, HERE, parent]):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root, "--one"],
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise RuntimeError(f"turn {turn} ({root}) failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["turn"] = turn
        rec["tree"] = "parent" if root == parent else "change"
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    _write(out, recs)


def _write(out, recs):
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(recs, f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other checkout, measured in turns with this one")
    ap.add_argument("--root", default=HERE, help="with --one: the checkout to measure")
    ap.add_argument("--one", action="store_true", help="one turn of one tree, as one JSON line")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(measure_tree(os.path.abspath(args.root))), flush=True)
    elif args.parent:
        compare_trees(os.path.abspath(args.parent), args.out)
    else:
        ap.error("one of --parent or --one")
    return 0


if __name__ == "__main__":
    sys.exit(main())

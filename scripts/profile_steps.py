#!/usr/bin/env python3
"""Profile the port's steps on one CUDA card with `torch.profiler`.

    python scripts/profile_steps.py [--steps slice,full_step,batch1,batch32] [--root DIR] [--out FILE]

For each step it runs one warm-up pass, then traces frames 20-24 of a
second pass: kernel launches per frame, host time inside the launch
calls, device busy time (the union of kernel intervals) and its share of
the traced wall time, device time by op, and the kernels each operator
launched. `slice` is the fused image -> pose step on the rendered 752x480
frames of `chip_smoke.py`; `full_step` is `pipeline.full_filter_step`
replaying the committed fixture in float32; `batch<B>` is
`pipeline.make_batched_full_step` on the batched fixture's four sequences
tiled to B, float32.

`--root` is the checkout whose `uvio_tpu_torch` is profiled (default:
the one holding this script); the inputs are always made by this
checkout's `chip_smoke.py`, so one run can profile two trees on the same
card. Prints one JSON line per step and writes them all to `--out`.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
WARM, TRACED = 20, 5


def _busy_ms(events, device_type):
    """Union of the device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.device_type == device_type)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def trace(frames, n_frames):
    """Trace `frames` (an iterator that runs one step per `next`) for
    n_frames steps; returns the per-frame figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            next(frames)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    by_op = {}
    for e in prof.events():
        if e.name.startswith("aten::") and e.kernels:
            by_op[e.name] = by_op.get(e.name, 0) + len(e.kernels)
    launches = sum(e.count for e in ka if e.key in LAUNCH_KEYS)
    launch_host = sum(e.cpu_time_total for e in ka if e.key in LAUNCH_KEYS) / 1e3
    busy = _busy_ms(prof.events(), torch.autograd.DeviceType.CUDA)
    ops = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in ka if e.device_time_total > 0),
                 key=lambda x: -x[1])
    return {"frames": n_frames, "launches_per_frame": launches / n_frames,
            "launch_host_ms_per_frame": launch_host / n_frames,
            "wall_ms_per_frame_traced": wall / n_frames, "device_busy_ms_per_frame": busy / n_frames,
            "device_idle_share": 1.0 - busy / wall,
            "top_device_ops_ms": [(k, round(ms, 4), c) for k, ms, c in ops[:20]],
            "kernels_per_frame_by_op": sorted(((k, n / n_frames) for k, n in by_op.items()), key=lambda x: -x[1])[:10]}


def profile_slice(smoke, dev):
    from uvio_tpu_torch import _build

    _build.build()
    _build.load()
    sim, imgs, stamps, imu = smoke.render(60)
    steps = smoke.slice_steps(dev, sim, imgs, stamps, imu)[0]
    for _ in steps():  # warm-up pass
        pass
    frames = steps()
    for _ in range(WARM):
        next(frames)
    return trace(frames, TRACED)


def profile_full_step(smoke, dev):
    import torch

    _, step, plans, bundles, st0 = smoke.full_step_inputs(dev, torch.float32)

    def frames():
        st = st0
        for fb, plan in zip(bundles, plans):
            st, _ = step(st, fb, plan)
            yield st

    for _ in frames():  # warm-up pass
        pass
    it = frames()
    for _ in range(WARM):
        next(it)
    return trace(it, TRACED)


def profile_batch(smoke, dev, B):
    import torch

    _, step, st0, staged = smoke.batch_inputs(dev, torch.float32, B)

    def frames():
        st = st0
        for fb, plan in staged:
            st, _ = step(st, fb, plan)
            yield st

    for _ in frames():  # warm-up pass
        pass
    it = frames()
    for _ in range(WARM):
        next(it)
    return trace(it, TRACED)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", default="slice,full_step")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_steps: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = []
    for name in args.steps.split(","):
        if name.startswith("batch"):
            rec = {"step": name, "root": root, "card": card, **profile_batch(smoke, dev, int(name[5:]))}
        else:
            fn = {"slice": profile_slice, "full_step": profile_full_step}[name]
            rec = {"step": name, "root": root, "card": card, **fn(smoke, dev)}
        out.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k not in ("top_device_ops_ms", "kernels_per_frame_by_op")}),
              flush=True)
        for row in rec["top_device_ops_ms"][:10]:
            print("   ", row, flush=True)
        print("    kernels a frame by operator:", rec["kernels_per_frame_by_op"][:6], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

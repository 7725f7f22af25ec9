#!/usr/bin/env python3
"""How many device records `torch.profiler` drops at the start of a trace,
on the card.

Traces 5 `DescriptorTracker.feed`s (752x480 rendered frames, graphed and
eager; a feed's device step opens with the `fast9` kernel) in a fresh
process, then again after `chip_smoke.py`'s tracker runs (a) and (b) have
run in the same process, each time plainly and opened by 32 uncounted spin
kernels as `chip_smoke.launch_profile` opens its traces. Prints one JSON
line a trace: device records (spin kernels apart), `fast9` records, spin
records seen, kernel launch API records.

    python3 scripts/profiler_drops.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEDS = 5


def trace(make_tracker, frames, spin):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr = make_tracker()
    for tc, img in frames[:2]:
        tr.feed(tc, img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if spin:
            for _ in range(32):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        for tc, img in frames[2:2 + FEEDS]:
            tr.feed(tc, img)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    spins = sum("spin_kernel" in e.name() for e in device)
    launches = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"}
    return {"device_records": len(device) - spins, "fast9_records": sum("fast9_kernel" in e.name() for e in device),
            "spin_records": spins, "launch_api_records": sum(e.name() in launches for e in events)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from uvio_tpu_torch import _build
    from uvio_tpu_torch.frontend import kernels as K
    from uvio_tpu_torch.frontend.descriptor import DescriptorTracker
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3), trajectory=circle_trajectory(duration=10.0))
    cam = sim.params.cameras[0]
    frames = []
    for _ in range(2 + FEEDS):
        tc, _ = sim.get_next_cam()
        frames.append((tc, sim.render_image(tc)))

    def make(eager):
        def tracker():
            tr = DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8))
            if eager:
                tr.step_first, tr.step_match = tr.step_first.eager, tr.step_match.eager
            return tr
        return tracker

    def report(when):
        for eager in (False, True):
            for spin in (False, True):
                rec = trace(make(eager), frames, spin)
                print(json.dumps({"when": when, "step": "eager" if eager else "graphed", "spin_opened": spin,
                                  "feeds": FEEDS, **rec}), flush=True)

    report("fresh process")
    t0 = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    C.tracker_mono_hard(K, card)
    C.tracker_stereo(K, card)
    report(f"after tracker runs (a) and (b), {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Per-stage timing of the port's filter step, on the card (or the CPU).

The port's twin of `examples/profile_step.py`, on the same layout (12
clones, a 24-sample IMU batch, 40 features of random tracks, no SLAM) and
the same random inputs (`np.random.default_rng(0)`): it fills the clone
window, then times marginalize, propagate+clone, the MSCKF update, the
fused `filter_step` and a 100-frame chunk of steps, to show where the
frame budget goes.

    python examples/profile_step_torch.py            # cuda:0
    python examples/profile_step_torch.py --cpu

On the card every stage is timed twice over the same loop, by the host
clock to a `torch.cuda.synchronize()` and by CUDA events, and one more
call of each is traced by `torch.profiler` for its kernel launches. It
prints the five lines of the JAX script, with the event clock and the
launches beside the host clock, then one JSON line.
"""

import argparse
import json
import time

import numpy as np


def timed(fn, dev, iters, warmup=2):
    """(host ms, event ms or None) per call of fn() over `iters` calls,
    warm: the host clock runs to a synchronize, the events (on a card)
    bracket the same calls."""
    import torch

    cuda = dev.type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if cuda:
        end.record()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters * 1e3
    return host, (start.elapsed_time(end) / iters if cuda else None)


def launches(fn, dev):
    """Kernel launches of one call of fn(), by `torch.profiler` (None off
    a card)."""
    if dev.type != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    keys = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.name() in keys for e in prof.profiler.kineto_results.events())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    ap.add_argument("--iters", type=int, default=50, help="timed calls of each stage")
    ap.add_argument("--chunk", type=int, default=100, help="frames of the chunk")
    ap.add_argument("--chunk-iters", type=int, default=5, help="timed chunks")
    args = ap.parse_args(argv)

    import torch

    from uvio_tpu_torch.device import resolve_device
    from uvio_tpu_torch.filter.ekf import marginalize_clone
    from uvio_tpu_torch.filter.propagator import propagate_and_clone
    from uvio_tpu_torch.pipeline import StepConfig, filter_step, make_step
    from uvio_tpu_torch.types import StateLayout, init_state
    from uvio_tpu_torch.types.state import oldest_clone_slot
    from uvio_tpu_torch.update.msckf import msckf_update

    dev = resolve_device("cpu" if args.cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("backend:", dev.type, name)
    layout = StateLayout(max_clones=12, max_imu_batch=24, max_slam=0)
    cfg = StepConfig(layout=layout, sigma_pix=1.0)
    F, K, C, M = 40, layout.max_clones, layout.num_cams, layout.max_imu_batch
    f32, f64 = torch.float32, torch.float64
    t = lambda a, dtype=f32: torch.as_tensor(a, dtype=dtype, device=dev)

    rng = np.random.default_rng(0)
    state = init_state(layout, dtype=f32, device=dev).replace(
        time=t(0.0, f64),
        cov=t(np.eye(layout.dim) * 1e-4),
        calib_cam_intr=t(np.tile([458.0, 458.0, 367.0, 248.0, 0, 0, 0, 0], (C, 1))),
    )
    imu_t = np.linspace(0.0, 0.1, M)
    imu_w = t(0.1 * rng.standard_normal((M, 3)))
    imu_a = t(np.tile([0.0, 0.0, 9.81], (M, 1)) + 0.2 * rng.standard_normal((M, 3)))
    uv = t(rng.uniform(100, 600, (F, K, C, 2)))
    mask = t(rng.uniform(size=(F, K, C)) < 0.6, torch.bool)

    # fill the window first
    step = make_step(cfg)
    for i in range(K + 2):
        state, _ = step(state, t(imu_t + 0.1 * i, f64), imu_w, imu_a, uv, mask)

    marg = lambda s: marginalize_clone(s, layout, oldest_clone_slot(s, layout))
    prop = lambda s, ts: propagate_and_clone(s, layout, ts, imu_w, imu_a, cfg.noises, cfg.gravity_mag)
    upd = lambda s: msckf_update(s, layout, cfg.cam_model, uv, mask, sigma_pix=cfg.sigma_pix,
                                 chi2_mult=cfg.chi2_mult)
    sm = marg(state)
    t100, t200 = t(imu_t + 100.0, f64), t(imu_t + 200.0, f64)
    sp = prop(sm, t100)

    T = args.chunk
    frames = [t(300.0 + k * 0.1 + np.linspace(0, 0.1, M), f64) for k in range(T)]

    def chunk(s):
        for ts in frames:
            s, _ = filter_step(s, ts, imu_w, imu_a, uv, mask, cfg=cfg)
        return s

    stages = {
        "marginalize": (lambda: marg(state), args.iters),
        "propagate_clone": (lambda: prop(sm, t100), args.iters),
        "msckf_update": (lambda: upd(sp)[0], args.iters),
        "fused_step": (lambda: step(state, t200, imu_w, imu_a, uv, mask)[0], args.iters),
        "chunk": (lambda: chunk(state), args.chunk_iters),
    }
    res = {}
    for key, (fn, iters) in stages.items():
        host, event = timed(fn, dev, iters, warmup=1 if key == "chunk" else 2)
        res[key] = {"host_ms": host, "event_ms": event, "launches": launches(fn, dev)}
    for key in ("host_ms", "event_ms"):
        if res["chunk"][key] is not None:
            res["chunk"][key] /= T
    if res["chunk"]["launches"] is not None:
        res["chunk"]["launches"] /= T

    def line(label, key, note=""):
        r = res[key]
        extra = "" if r["event_ms"] is None else f" | events {r['event_ms']:8.3f} ms, {r['launches']:.0f} launches"
        print(f"{label} {r['host_ms']:8.3f} ms{note}{extra}")

    line("marginalize     ", "marginalize")
    line("propagate+clone ", "propagate_clone")
    line("msckf update    ", "msckf_update")
    line("fused step      ", "fused_step", " (dispatch overhead incl.)")
    print(f"chunk/frame      {res['chunk']['host_ms']:8.3f} ms -> {1e3 / res['chunk']['host_ms']:.1f} fps"
          + ("" if res["chunk"]["event_ms"] is None else
             f" | events {res['chunk']['event_ms']:8.3f} ms, {res['chunk']['launches']:.0f} launches a frame"))
    print(json.dumps({"platform": "gpu" if dev.type == "cuda" else "cpu", "device": name, "chunk_frames": T,
                      "iters": args.iters, "stages": res, "chunk_fps": 1e3 / res["chunk"]["host_ms"]}), flush=True)


if __name__ == "__main__":
    main()

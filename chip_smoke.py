#!/usr/bin/env python3
"""Build the port's CUDA kernels and run its raw-image -> pose step and
its UWB + SLAM filter step on one NVIDIA GPU: the quickest proof that
`uvio_tpu_torch` works on the card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card   — `nvidia-smi` name and power limit; full-float32 matmuls set;
  2. build  — nvcc builds csrc/*.cu (sm_90a) from the checkout, one process
              per source; the `-Xptxas -v` report goes to stderr;
  3. yardsticks — an empty kernel on each kernel's grid and `out.copy_(img)`
              of the 752x480 float32 frame, by the graph clock below;
  4. fast9  — kernel vs plain PyTorch on a rendered 752x480 frame, a random
              one and a random 65x257 one (a width that takes the scalar
              path); max abs diff <= 1e-4, 0.0 in practice; its time also
              on a frame of zeros and a random one (no ring pass, or one
              for nearly every pixel);
  5. lk_level — kernel vs plain on the 4 pyramid levels of two rendered
              frames, 150 features, both iteration settings (ok masks
              differ in at most 1 of 150, <= 1e-3 px where both keep a
              track);
  6. lk_track — the one-launch pyramid on the same frames: bitwise equal to
              the chain of four `lk_level` launches; against the plain
              chain, at most 2 of 150 masks and <= 1e-3 px on jointly kept
              tracks that float32 determines; the same bitwise on a pair
              with a flow of (96, -80) px, where windows leave the staged
              slab; and `lk_level` from guesses 10 px off on a smooth
              scene, every one of which stages its slab again.
     Kernel times are by two clocks: `ms` replays a CUDA graph of 100
     launches of the C entry point (no Python between launches: device
     time), `wrapper_ms` is a Python loop over the wrapper between two
     events (the host's pace when the device drains faster). L2 is warm in
     both, as on the main path, which finds the pyramid just written.
  7. slice  — the simulator renders 60 frames (752x480, seed 9, 200 Hz
              IMU, 10 Hz camera); the fused step runs each on cuda:0 with
              a float32 state; gates of tests/test_fused_vio.py; exactly 1
              fast9 and 1 lk_track launch per step; median per-frame time
              over 3 warm repetitions; the two kernels' device time by name
              under `torch.profiler` over 5 steps.
  8. full_step — `pipeline.full_filter_step` replays the 100 frames of the
              committed fixture (`bench.py`'s scenario: seed 7, 25 SLAM
              slots, 4 UWB anchors) on cuda:0. float64: every info equal
              to the JAX float64 replay's, position within 1e-6 m and
              trace(cov) within 1e-6 relative on every frame. float32 (with
              float64 time): cov_ok on every frame, final position within
              2 cm of the JAX float32 replay's, RMS error against ground
              truth at most the JAX one's + 2 cm, accepted ranges within 2%,
              all 25 SLAM slots full at the end; median per-frame time over
              3 warm repetitions; host syncs over one whole warm replay,
              with how many frames took each branch of the plan. It runs no hand
              kernel (its inputs are features, not images).
Then the kernel table (with each kernel's bound: the larger of its bytes
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted from
this run's inputs), the `nvidia-smi` line, and the result line.
Needs no network; any failed check raises.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def log(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events), warm."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(launch, k=100, replays=20):
    """Device time of one launch() in ms: k launches captured in one CUDA
    graph, replayed `replays` times to warm the clocks and then `replays`
    times between two events. launch() must enqueue on the current stream
    and allocate nothing."""
    import torch

    launch()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(k):
            launch()
    for _ in range(replays):
        g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (k * replays)


def sm_clock_under_load(launch, seconds=1.0):
    """The SM clock `nvidia-smi` reads while a graph of launch() replays
    for about `seconds`: what the graph clock's times were taken at."""
    import torch

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(100):
            launch()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while smi.poll() is None or time.perf_counter() - t0 < seconds:
        for _ in range(10):
            g.replay()
        torch.cuda.synchronize()
    return smi.communicate()[0].strip()


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def _checked(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12
HALF, ITERS, COARSE_ITERS, LEVELS = 7, 10, 6, 4  # the main path's LK settings


def bound_ms(n_bytes, n_ops):
    """(least ms the card could take, "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def kernel_inputs(dev, imgs):
    """The kernels' inputs at the main path's shapes: the first two
    rendered frames equalized, their 4-level pyramids, 150 seeded feature
    positions at least 24 px inside, all valid."""
    import numpy as np
    import torch

    from uvio_tpu_torch.frontend.klt import build_pyramid, hist_equalize

    rendered = hist_equalize(torch.as_tensor(imgs[0], device=dev))
    pyr0 = build_pyramid(rendered, LEVELS)
    pyr1 = build_pyramid(hist_equalize(torch.as_tensor(imgs[1], device=dev)), LEVELS)
    rng = np.random.default_rng(0)
    uv0 = torch.as_tensor(rng.uniform([24, 24], [752 - 24, 480 - 24], (150, 2)),
                          dtype=torch.float32, device=dev)
    valid = torch.ones(150, dtype=torch.bool, device=dev)
    return {"rendered": rendered, "pyr0": pyr0, "pyr1": pyr1, "uv0": uv0, "valid": valid}


def time_kernels(lib, K, inp):
    """Both clocks for every kernel `lib` (a bound kernel library) and `K`
    (its package's `frontend.kernels`) have, at the main path's shapes and
    settings: {"fast9": {"ms", "wrapper_ms"}, "lk_level": {..., "levels_ms"},
    "lk_track": {...}}. `lk_level` sums the four levels."""
    import torch

    img, pyr0, pyr1, uv0, valid = (inp[k] for k in ("rendered", "pyr0", "pyr1", "uv0", "valid"))
    H, W = img.shape
    N = uv0.shape[0]
    out = {}
    score = torch.empty_like(img)
    out["fast9"] = {
        "ms": graph_ms(lambda: _checked(lib.uvio_fast9(
            img.data_ptr(), score.data_ptr(), H, W, 20.0, _stream()), "uvio_fast9")),
        "wrapper_ms": cuda_ms(lambda: K.fast_score(img, 20.0), 200),
    }
    uv_out, ok_out = torch.empty_like(uv0), torch.empty_like(valid)
    levels_ms, wrapper_ms = [], 0.0
    for lev in range(LEVELS):
        uv_l = (uv0 / 2.0**lev).contiguous()
        iters, min_eig = (ITERS, 25.0) if lev == 0 else (COARSE_ITERS, 0.0)
        h, w = pyr0[lev].shape
        levels_ms.append(graph_ms(lambda: _checked(lib.uvio_lk_level(
            pyr0[lev].data_ptr(), pyr1[lev].data_ptr(), h, w, uv_l.data_ptr(), uv_l.data_ptr(),
            valid.data_ptr(), uv_out.data_ptr(), ok_out.data_ptr(), N, HALF, iters, min_eig,
            _stream()), "uvio_lk_level")))
        wrapper_ms += cuda_ms(lambda: K.lk_level(pyr0[lev], pyr1[lev], uv_l, uv_l, valid, HALF,
                                                 iters, min_eig), 200)
    out["lk_level"] = {"ms": sum(levels_ms), "levels_ms": levels_ms, "wrapper_ms": wrapper_ms}
    if hasattr(lib, "uvio_lk_track"):
        args = K.lk_track_args(pyr0, pyr1)
        out["lk_track"] = {
            "ms": graph_ms(lambda: _checked(lib.uvio_lk_track(
                *args, LEVELS, uv0.data_ptr(), valid.data_ptr(), uv_out.data_ptr(),
                ok_out.data_ptr(), N, HALF, ITERS, COARSE_ITERS, K.LK_MIN_EIG, _stream()),
                "uvio_lk_track")),
            "wrapper_ms": cuda_ms(lambda: K.lk_track(pyr0, pyr1, uv0, valid, HALF, ITERS,
                                                     COARSE_ITERS), 200),
        }
    return out


def time_yardsticks(lib, img, grids):
    """What a launch and FAST-9's bytes cost at least, by the graph clock:
    an empty kernel on each named grid (gx, gy, threads) and `out.copy_(img)`."""
    import torch

    out = {f"empty_{name}_ms": graph_ms(lambda: _checked(lib.uvio_empty_launch(
        *grid, _stream()), "uvio_empty_launch")) for name, grid in grids.items()}
    dst = torch.empty_like(img)
    out["copy_ms"] = graph_ms(lambda: dst.copy_(img))
    out["sm_clock_under_replay"] = sm_clock_under_load(lambda: dst.copy_(img))
    return out


def profiled_kernel_ms(run, names=("fast9_kernel", "lk_kernel", "lk_level_kernel")):
    """Mean device time per launch, by kernel name, of the hand kernels
    that run() launches, from `torch.profiler`: {name: {"ms", "count"}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in names:
            if f"::{name}" in e.key and e.device_time_total > 0:
                out[name] = {"ms": e.device_time_total / e.count / 1e3, "count": e.count}
    return out


def fast9_bound(K, img, thresh=20.0):
    """FAST-9's bound on this image: the image read and the score written
    once; 12 operations a pixel for the pretest (4 differences, 8
    compares) and 96 more (16 x difference, 2 compares, abs, subtract,
    add) for each interior pixel that passes it."""
    H, W = img.shape
    survivors = int(K.fast_pretest(img, thresh)[3:-3, 3:-3].sum().item())
    return bound_ms(2 * H * W * 4, 12 * H * W + 96 * survivors) + (survivors,)


def lk_bounds(K, inp):
    """The bounds of `lk_track` and of the four `lk_level` launches on
    these inputs. Bytes: the distinct pixels the features touch, 4 bytes
    each: per level, of `pyr_prev` the 16x16 template blocks and of
    `pyr_next` the 16x16 window blocks of every iteration (recorded from
    the plain version), each pixel counted once however many features or
    iterations read it; plus positions, flags and results (17 bytes a
    feature: once for the fused launch, 25 per level for the chain, which
    also reads a guess). Operations: 19 per template pixel (blend 9,
    gradients 4, structure tensor 6) and 14 per window pixel and
    iteration (blend 9, residual 1, two multiply-adds)."""
    import torch

    P = 2 * HALF + 1
    N = inp["uv0"].shape[0]
    per_level = []

    def touched(shape, blocks):
        """Distinct pixels under the (P+1)^2 blocks starting at (x, y)."""
        mask = torch.zeros(shape, dtype=torch.bool, device=inp["uv0"].device)
        ar = torch.arange(P + 1, device=mask.device)
        for x, y in blocks:
            mask[(y[:, None] + ar)[:, :, None], (x[:, None] + ar)[:, None, :]] = True
        return int(mask.sum().item())

    def level(img_prev, img_next, uv_l, *rest):
        wins = []
        res = K.lk_level_ref(img_prev, img_next, uv_l, *rest, windows=wins)
        tx, ty = K._window(uv_l, HALF, *img_prev.shape)[:2]
        pixels = touched(img_prev.shape, [(tx, ty)]) + touched(img_next.shape, wins)
        per_level.append((4 * pixels, len(wins)))
        return res

    K.lk_track_ref(inp["pyr0"], inp["pyr1"], inp["uv0"], inp["valid"], HALF, ITERS, COARSE_ITERS,
                   level_fn=level)
    image_bytes = sum(b for b, _ in per_level)
    ops = sum(N * P * P * (19 + 14 * n_it) for _, n_it in per_level)
    return {"lk_track": bound_ms(image_bytes + 17 * N, ops),
            "lk_level": bound_ms(image_bytes + 25 * N * LEVELS, ops),
            "image_bytes": image_bytes, "operations": ops,
            "image_bytes_coarse_to_fine": [b for b, _ in per_level]}


def check_fast9(K, dev, rendered):
    """FAST-9 against its plain version on the rendered frame, a random
    one and a random 65x257 one (scalar path); returns the max abs diff."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = torch.rand((480, 752), generator=gen, device=dev) * 255.0
    odd = torch.rand((65, 257), generator=gen, device=dev) * 255.0
    err = 0.0
    for img in (rendered, rnd, odd):
        a = K.fast_score(img, 20.0)
        b = K.fast_score_ref(img, 20.0)
        err = max(err, (a - b).abs().max().item())
        if (a > 0).sum().item() == 0:
            raise RuntimeError("fast9 found no corners")
    if not err <= 1e-4:
        raise RuntimeError(f"fast9 disagrees with its plain version: {err}")
    return err


def check_lk_level(K, inp):
    """`lk_level` against its plain version on all 4 levels under both
    iteration settings; logs each and returns the max position error."""
    pyr0, pyr1, uv0, valid = (inp[k] for k in ("pyr0", "pyr1", "uv0", "valid"))
    lk_err = 0.0
    for lev in range(LEVELS):
        uv_l = (uv0 / 2.0**lev).contiguous()
        for iters, min_eig in ((ITERS, 25.0), (COARSE_ITERS, 0.0)):
            args = (pyr0[lev], pyr1[lev], uv_l, uv_l, valid, HALF, iters, min_eig)
            uv_k, ok_k = K.lk_level(*args)
            uv_r, ok_r = K.lk_level_ref(*args)
            diff = (ok_k != ok_r).nonzero().flatten().tolist()
            both = ok_k & ok_r
            e = (uv_k[both] - uv_r[both]).abs().max().item() if both.any().item() else 0.0
            rec = {"phase": "lk_level", "level": lev, "shape": list(pyr0[lev].shape),
                   "iters": iters, "min_eig": min_eig, "ok": int(ok_k.sum().item()),
                   "ok_plain": int(ok_r.sum().item()), "ok_differs": diff, "max_abs_err": e}
            if diff:
                rec["differing"] = [{"i": i, "uv": uv_l[i].tolist(), "kernel": uv_k[i].tolist(),
                                     "plain": uv_r[i].tolist()} for i in diff]
            log(rec)
            if len(diff) > 1 or not e <= 1e-3:
                raise RuntimeError("lk_level disagrees with its plain version")
            lk_err = max(lk_err, e)
    return lk_err


def smooth_scene(dev):
    """A 200x260 Gaussian-smoothed noise image, a copy moved by (2, -1)
    px, 40 feature positions, and guesses 10 px off on the first 20: on
    ground this smooth LK converges from there, across the slab's edge."""
    import numpy as np
    import torch
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(1)
    img = gaussian_filter(rng.uniform(0, 255, (200, 260)), 8.0)
    img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)
    uv = np.stack([rng.uniform(50, 210, 40), rng.uniform(50, 150, 40)], 1).astype(np.float32)
    guess = uv.copy()
    guess[:20] += np.array([10.0, -10.0], np.float32)
    on = lambda a: torch.as_tensor(a, device=dev)
    return on(img), on(np.roll(img, (-1, 2), axis=(0, 1))), on(uv), on(guess)


def check_lk_track(K, dev, inp):
    """The one-launch pyramid: bitwise against the chain of `lk_level`
    launches (also on a far flow that leaves the slab), against the plain
    chain, and `lk_level` from far guesses. Returns the phase's record."""
    import torch

    from uvio_tpu_torch.frontend.klt import build_pyramid

    pyr0, pyr1, uv0, valid = (inp[k] for k in ("pyr0", "pyr1", "uv0", "valid"))
    cfg = (HALF, ITERS, COARSE_ITERS)

    def fused_vs_chain(p0, p1, what):
        uv_f, ok_f = K.lk_track(p0, p1, uv0, valid, *cfg)
        uv_c, ok_c = K.lk_track_ref(p0, p1, uv0, valid, *cfg, level_fn=K.lk_level)
        if not (torch.equal(uv_f, uv_c) and torch.equal(ok_f, ok_c)):
            log({"phase": "lk_track", "case": what, "ok_differs": int((ok_f != ok_c).sum().item()),
                 "uv_differs": int((uv_f != uv_c).any(1).sum().item())})
            raise RuntimeError(f"lk_track differs from the chained lk_level launches ({what})")
        return uv_f, ok_f

    uv_f, ok_f = fused_vs_chain(pyr0, pyr1, "rendered frames 0 and 1")
    uv_r, ok_r = K.lk_track_ref(pyr0, pyr1, uv0, valid, *cfg)
    uv_64, _ = K.lk_track_ref([p.double() for p in pyr0], [p.double() for p in pyr1], uv0.double(),
                              valid, *cfg)
    # positions are compared where float32 determines the answer: the plain
    # chain lies within 2.5e-4 px of its float64 evaluation
    stable = (uv_r.double() - uv_64).abs().amax(1) < 2.5e-4
    both = ok_f & ok_r
    rec = {"phase": "lk_track", "bitwise_equal_to_chained_levels": True,
           "ok": int(ok_f.sum().item()), "ok_plain": int(ok_r.sum().item()),
           "ok_differs": int((ok_f != ok_r).sum().item()), "jointly_kept": int(both.sum().item()),
           "max_abs_err_jointly_kept": (uv_f[both] - uv_r[both]).abs().max().item(),
           "float32_determined": int((both & stable).sum().item()),
           "max_abs_err": (uv_f[both & stable] - uv_r[both & stable]).abs().max().item()}
    if (rec["ok_differs"] > 2 or not rec["max_abs_err"] <= 1e-3
            or rec["float32_determined"] < 0.85 * rec["jointly_kept"]):
        log(rec)
        raise RuntimeError("lk_track disagrees with its plain version")

    # a flow of (96, -80) px: windows leave the staged slab at every level
    far = build_pyramid(torch.roll(inp["rendered"], (-80, 96), (0, 1)), LEVELS)
    restaged = []

    def slab_level(*args):
        uv_l, ok_l, n = K.lk_level_slab_ref(*args)
        restaged.append(int((n >= 2).sum().item()))
        return uv_l, ok_l

    K.lk_track_ref(pyr0, far, uv0, valid, *cfg, level_fn=slab_level)
    fused_vs_chain(pyr0, far, "flow of (96, -80) px")
    rec["far_flow"] = {"bitwise_equal_to_chained_levels": True,
                       "features_restaged_per_level_coarse_to_fine": restaged}
    if sum(restaged) < 10:
        log(rec)
        raise RuntimeError("the far-flow case staged no slab again")

    # guesses 10 px off on smooth ground: the plain version follows them
    # across the slab's edge, and the kernel must stage again to agree
    img, moved, uv_s, guess = smooth_scene(dev)
    args = (img, moved, uv_s, guess, torch.ones(40, dtype=torch.bool, device=dev), HALF, 20, 25.0)
    uv_k, ok_k = K.lk_level(*args)
    uv_p, ok_p, n_staged = K.lk_level_slab_ref(*args)
    flow = torch.tensor([2.0, -1.0], device=dev)
    settled = ok_k & ok_p & ((uv_p - uv_s - flow).abs().amax(1) < 0.05)
    far_rec = {"restaged_of_20_moved": int((n_staged[:20] >= 2).sum().item()),
               "restaged_of_20_in_place": int((n_staged[20:] >= 2).sum().item()),
               "ok_differs": int((ok_k != ok_p).sum().item()),
               "settled_on_the_flow": int(settled.sum().item()),
               "settled_and_restaged": int((settled[:20] & (n_staged[:20] >= 2)).sum().item()),
               "max_abs_err_settled": (uv_k[settled] - uv_p[settled]).abs().max().item()}
    rec["guess_10px_off"] = far_rec
    if (far_rec["settled_and_restaged"] < 10 or far_rec["ok_differs"] > 1
            or not far_rec["max_abs_err_settled"] <= 1e-3):
        log(rec)
        raise RuntimeError("lk_level with far guesses disagrees with its plain version")
    return rec


def render(n_frames):
    """Frames, stamps and IMU rows from the port's simulator."""
    import numpy as np

    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(
        SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9),
        trajectory=circle_trajectory(duration=14.0),
    )
    imgs, stamps, imu = [], [], []
    while sim.ok() and len(imgs) < n_frames:
        t, wm, am = sim.get_next_imu()
        imu.append((t, *wm, *am))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            tc = sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam
            sim.cur_cam_t = tc
            imgs.append(sim.render_image(tc))
            stamps.append(tc)
    if len(imgs) != n_frames:
        raise RuntimeError(f"simulator gave {len(imgs)} of {n_frames} frames")
    return sim, imgs, stamps, np.asarray(imu)


def slice_steps(dev, sim, imgs, stamps, imu):
    """The fused image -> pose step on the rendered frames, float32 state
    on `dev`: (steps, step, make_carry, st0, frames, windows), where
    steps() runs the 59 steps from the first frame and yields
    (state, info) after each."""
    import numpy as np
    import torch

    from uvio_tpu_torch.filter.propagator import select_imu_readings_np
    from uvio_tpu_torch.frontend.fused_vio import make_fused_vio_step
    from uvio_tpu_torch.types import StateLayout, init_state

    cam = sim.params.cameras[0]
    layout = StateLayout(max_clones=11, max_imu_batch=32, max_slam=0)
    step, make_carry = make_fused_vio_step(layout, cam.intrinsics, cam.model, device=dev,
                                           sigma_pix=2.0)
    f32, f64 = torch.float32, torch.float64
    g0 = sim.get_gt_state(stamps[0])
    st0 = init_state(layout, dtype=f32, device=dev)
    on = lambda x, dt=f32: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    st0 = st0.replace(
        time=on(stamps[0], f64), q=on(g0["q_GtoI"]), p=on(g0["p_IinG"]), v=on(g0["v_IinG"]),
        bg=on(g0["bg"]), ba=on(g0["ba"]), q_fej=on(g0["q_GtoI"]), p_fej=on(g0["p_IinG"]),
        v_fej=on(g0["v_IinG"]), calib_cam_q=on(cam.q_ItoC)[None], calib_cam_p=on(cam.p_IinC)[None],
        calib_cam_intr=on(cam.intrinsics)[None],
        cov=on(np.diag([1e-5] * 6 + [1e-4] * 3 + [1e-5] * 6 + [0.0] * (layout.dim - 15))),
    )
    frames = [on(im) for im in imgs]
    windows, cur = [], stamps[0]
    for i in range(1, len(stamps)):
        t, w, a = select_imu_readings_np(imu[:, 0], imu[:, 1:4], imu[:, 4:7], cur, stamps[i],
                                         layout.max_imu_batch)
        windows.append((on(t, f64), on(w, f64), on(a, f64), on(stamps[i], f64)))
        cur = stamps[i]

    def steps():
        gen = torch.Generator(device=dev).manual_seed(0)
        st, carry = st0, make_carry(frames[0])
        for i, (t, w, a, ts) in enumerate(windows):
            st, carry, info = step(st, carry, frames[i + 1], t, w, a, ts, generator=gen)
            yield st, info

    return steps, step, make_carry, st0, frames, windows


INFO_KEYS = ("slam_kept", "slam_failed", "slam_inited", "uwb_accepted", "cov_ok")


def _frame_infos(info):
    """The per-frame infos the fixture records, as numpy."""
    out = {k: info[k].cpu().numpy() for k in INFO_KEYS}
    out["num_used"] = info["msckf"]["num_used"].cpu().numpy()
    out["msckf_kept"] = info["msckf"]["kept"].cpu().numpy()
    return out


def full_step_inputs(dev, dtype):
    """The committed fixture, the full step, the host plans of its 100
    bundles, and the bundles and initial state uploaded to `dev` in
    `dtype`: (fx, step, plans, bundles, st0)."""
    from uvio_tpu_torch.fixtures import load_full_step_fixture
    from uvio_tpu_torch.pipeline import FullStepConfig, bundle_from_numpy, make_full_step, plan_frame
    from uvio_tpu_torch.types.state import state_from_numpy

    fx = load_full_step_fixture()
    step = make_full_step(FullStepConfig.from_dict(fx.config))
    plans, t = [], float(fx.state0["time"])
    for b in fx.bundles:
        plans.append(plan_frame(b, t))
        t = float(b["stamp_time"])
    bundles = [bundle_from_numpy(b, dev, dtype) for b in fx.bundles]
    return fx, step, plans, bundles, state_from_numpy(fx.state0, dev, dtype)


def full_step_phase(dev, card):
    """Replay the fixture through the full step in float64 and float32."""
    import warnings

    import numpy as np
    import torch

    def replay(dtype):
        """(run, fx, step, plans, bundles, state0): run() replays every
        frame, synchronizes and returns per-frame device results."""
        fx, step, plans, bundles, st0 = full_step_inputs(dev, dtype)

        def run():
            st, out = st0, []
            for fb, plan in zip(bundles, plans):
                st, info = step(st, fb, plan)
                out.append((st.p, st.cov.trace(), info))
            torch.cuda.synchronize()
            return st, out

        return run, fx, step, plans, bundles, st0

    # ---- float64: the same decisions as the JAX float64 replay --------
    run64, fx, _, _, _, _ = replay(torch.float64)
    n = len(fx.bundles)
    st, out = run64()
    ref = fx.replays["f64"]
    bad, p_err, tr_err = [], 0.0, 0.0
    for k, (p, tr, info) in enumerate(out):
        got = _frame_infos(info)
        diff = [key for key, v in got.items() if not np.array_equal(v, ref[key][k])]
        if diff:
            bad.append({"frame": k, "differs": diff,
                        "msckf_chi2": info["msckf"]["chi2"].cpu().tolist(),
                        "slam_chi2": info["slam_chi2"].cpu().tolist(),
                        "slam_init_chi2": info["slam_init_chi2"].cpu().tolist(),
                        "uwb_chi2": info["uwb_chi2"].cpu().tolist()})
        p_err = max(p_err, float(np.abs(p.cpu().numpy() - ref["p"][k]).max()))
        tr_err = max(tr_err, abs(float(tr) / float(ref["cov_trace"][k]) - 1.0))
    rec64 = {"phase": "full_step", "precision": "float64", "frames": n, "infos_equal_all": not bad,
             "max_p_diff_m": p_err, "max_trace_rel_diff": tr_err}
    log(rec64)
    if bad or not (p_err <= 1e-6 and tr_err <= 1e-6):
        for b in bad:
            log(b)
        raise RuntimeError("full_step float64 disagrees with the JAX float64 replay")

    # ---- float32: the bench precision, held to the JAX float32 replay -
    run32, fx, step, plans, bundles, st0 = replay(torch.float32)
    st, out = run32()
    ref = fx.replays["f32"]
    p = np.stack([o[0].cpu().numpy() for o in out]).astype(np.float64)
    cov_ok = [bool(o[2]["cov_ok"].item()) for o in out]
    uwb = sum(int(o[2]["uwb_accepted"].sum().item()) for o in out)
    uwb_ref = int(ref["uwb_accepted"].sum())
    rms = float(np.sqrt(np.mean(np.sum((p - fx.gt_p) ** 2, axis=1))))
    rms_ref = float(np.sqrt(np.mean(np.sum((ref["p"] - fx.gt_p) ** 2, axis=1))))
    final_diff = float(np.linalg.norm(p[-1] - ref["p"][-1]))
    slots = int(st.slam_valid.sum().item())
    rec32 = {"phase": "full_step", "precision": "float32", "frames": n, "cov_ok_all": all(cov_ok),
             "final_p_diff_vs_jax_m": final_diff, "rms_p_err_m": rms, "rms_p_err_jax_m": rms_ref,
             "uwb_accepted": uwb, "uwb_accepted_jax": uwb_ref, "slam_slots_end": slots}
    if not (all(cov_ok) and final_diff <= 0.02 and rms <= rms_ref + 0.02
            and abs(uwb - uwb_ref) <= 0.02 * uwb_ref and slots == fx.config["layout"]["max_slam"]):
        log(rec32)
        raise RuntimeError("full_step float32 failed its gates")

    # nothing inside a step should wait for the host; count what does over
    # one whole warm replay, which takes every branch of the plan
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st = st0
        for fb, plan in zip(bundles, plans):
            st, _ = step(st, fb, plan)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    branches = {"uwb_rows_run": sum(sum(p.uwb_rows) for p in plans),
                "uwb_rows_skipped": sum(len(p.uwb_rows) - sum(p.uwb_rows) for p in plans),
                "slam_init_frames": sum(p.slam_init for p in plans),
                "marg_frames": sum(p.marg for p in plans),
                "slam_init_and_marg_frames": sum(p.slam_init and p.marg for p in plans),
                "zupt_try_frames": sum(p.zupt_try for p in plans)}
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        run32()
        reps.append((time.perf_counter() - t0) / n * 1e3)
    rec32.update({"per_frame_ms_median": statistics.median(reps), "per_frame_ms_reps": reps,
                  "host_syncs_in_replay": len(caught), "replay_plans": branches,
                  "sync_sources": sorted({str(w.message).split("\n")[0][:120] for w in caught}),
                  "card": card})
    log(rec32)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from uvio_tpu_torch import _build
    from uvio_tpu_torch.frontend import kernels as K

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()})

    # ---- build -------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    lib = _build.load()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "lib": _build.LIB_PATH})
    print(report, file=sys.stderr)

    sim, imgs, stamps, imu = render(60)
    log({"phase": "render", "frames": len(imgs), "resolution": "752x480"})
    inp = kernel_inputs(dev, imgs)
    rendered, pyr0, pyr1, uv0, valid = (inp[k] for k in ("rendered", "pyr0", "pyr1", "uv0", "valid"))
    N = uv0.shape[0]

    # ---- yardsticks and both clocks ----------------------------------
    yard = time_yardsticks(lib, rendered, {"fast9_grid": (6, 60, 256), "lk_grid": (N, 1, 128)})
    log({"phase": "yardsticks", **yard, "l2": "warm", "card": card})
    clocks = time_kernels(lib, K, inp)
    kernels = {}

    # ---- fast9 vs plain ------------------------------------------------
    err = check_fast9(K, dev, rendered)
    b_ms, b_by, survivors = fast9_bound(K, rendered)
    kernels["fast9"] = dict(max_abs_err=err, **clocks["fast9"],
                            plain_ms=cuda_ms(lambda: K.fast_score_ref(rendered, 20.0), 20),
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # the ring pass is what varies: no survivor of the pretest, or nearly all
    score = torch.empty_like(rendered)
    by_content = {}
    for name, im in (("zeros", torch.zeros_like(rendered)),
                     ("random", torch.rand_like(rendered) * 255.0)):
        by_content[name] = {
            "pretest_survivors": int(K.fast_pretest(im, 20.0)[3:-3, 3:-3].sum().item()),
            "ms": graph_ms(lambda: _checked(lib.uvio_fast9(
                im.data_ptr(), score.data_ptr(), *im.shape, 20.0, _stream()), "uvio_fast9"))}
    log({"phase": "fast9", "shapes": [[480, 752], [480, 752], [65, 257]],
         "pretest_survivors": survivors, **kernels["fast9"], "ms_by_content": by_content,
         "card": card})

    # ---- lk_level vs plain ---------------------------------------------
    lk_err = check_lk_level(K, inp)
    lk_plain_ms = 0.0
    for lev in range(LEVELS):
        uv_l = (uv0 / 2.0**lev).contiguous()
        iters, min_eig = (ITERS, 25.0) if lev == 0 else (COARSE_ITERS, 0.0)
        lk_plain_ms += cuda_ms(lambda: K.lk_level_ref(pyr0[lev], pyr1[lev], uv_l, uv_l, valid, HALF,
                                                      iters, min_eig), 10)
    bounds = lk_bounds(K, inp)
    kernels["lk_level"] = dict(max_abs_err=lk_err, ms=clocks["lk_level"]["ms"],
                               wrapper_ms=clocks["lk_level"]["wrapper_ms"], plain_ms=lk_plain_ms,
                               bound_ms=bounds["lk_level"][0], bound_by=bounds["lk_level"][1],
                               library_ms=None)
    log({"phase": "lk_level", "four_levels_main_path_settings": kernels["lk_level"],
         "levels_ms": clocks["lk_level"]["levels_ms"], "card": card})

    # ---- lk_track: one launch for the pyramid --------------------------
    track_rec = check_lk_track(K, dev, inp)
    kernels["lk_track"] = dict(
        max_abs_err=track_rec["max_abs_err"], **clocks["lk_track"],
        plain_ms=cuda_ms(lambda: K.lk_track_ref(pyr0, pyr1, uv0, valid, HALF, ITERS, COARSE_ITERS), 10),
        bound_ms=bounds["lk_track"][0], bound_by=bounds["lk_track"][1], library_ms=None)
    log({**track_rec, **kernels["lk_track"], "image_bytes_touched": bounds["image_bytes"],
         "image_bytes_touched_coarse_to_fine": bounds["image_bytes_coarse_to_fine"],
         "operations": bounds["operations"], "card": card})

    # ---- the slice ---------------------------------------------------
    steps, step, make_carry, st0, frames, windows = slice_steps(dev, sim, imgs, stamps, imu)

    def run_slice():
        infos = []
        for st, info in steps():
            infos.append(info)
        torch.cuda.synchronize()
        return st, infos

    K.reset_launch_counts()
    st, infos = run_slice()
    launches = dict(K.launch_counts)
    n_steps = len(windows)
    if launches != {"fast9": n_steps, "lk_track": n_steps, "lk_level": 0}:
        raise RuntimeError(f"launch counts {launches} for {n_steps} steps")
    cov_ok = [bool(x["cov_ok"].item()) for x in infos]
    used = sum(int(x["num_used"].item()) for x in infos)
    tracks = int(infos[-1]["num_tracks"].item())
    perr = float(np.linalg.norm(st.p.cpu().numpy() - sim.get_gt_state(stamps[-1])["p_IinG"]))
    finite = bool(torch.isfinite(st.cov).all().item() and torch.isfinite(st.q).all().item())
    slice_rec = {"phase": "slice", "steps": n_steps, "cov_ok_all": all(cov_ok),
                 "num_tracks_end": tracks, "num_used_total": used, "final_p_err_m": perr,
                 "finite": finite, "launches": launches}
    if not (all(cov_ok) and tracks > 100 and used > 100 and perr < 0.5 and finite):
        log(slice_rec)
        raise RuntimeError("the slice failed its gates")

    # nothing inside a step should wait for the host; count what does
    torch.cuda.set_sync_debug_mode("warn")
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gen = torch.Generator(device=dev).manual_seed(0)
        carry = make_carry(frames[0])
        torch.cuda.synchronize()
        step(st0, carry, frames[1], *windows[0][:3], windows[0][3], generator=gen)
    torch.cuda.set_sync_debug_mode(0)
    sync_ops = sorted({str(w.message).split("\n")[0][:120] for w in caught})

    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_slice()
        reps.append((time.perf_counter() - t0) / n_steps * 1e3)
    # the same kernels' device time by name under the profiler, 5 steps
    def five_steps():
        frames_it = steps()
        for _ in range(5):
            next(frames_it)

    profiled = profiled_kernel_ms(five_steps)
    kernels["fast9"]["profiler_ms"] = profiled.get("fast9_kernel", {}).get("ms")
    kernels["lk_track"]["profiler_ms"] = profiled.get("lk_kernel", {}).get("ms")
    kernels["lk_level"]["profiler_ms"] = None  # not launched on the main path
    slice_rec.update({"per_frame_ms_median": statistics.median(reps), "per_frame_ms_reps": reps,
                      "host_syncs_in_one_step": len(caught), "sync_sources": sync_ops,
                      "profiled_kernels": profiled, "card": card})
    log(slice_rec)

    full_step_phase(dev, card)

    src = "uvio_tpu_torch/csrc/"
    log({"kernels": [
        {"name": "fast9", "route": "cuda", "source": src + "fast9.cu",
         "replaces": "uvio_tpu/frontend/pallas_kernels.py:78", "launches": launches["fast9"],
         **kernels["fast9"]},
        {"name": "lk_level", "route": "cuda", "source": src + "lk_level.cu",
         "replaces": "uvio_tpu/frontend/pallas_kernels.py:617", "launches": launches["lk_level"],
         **kernels["lk_level"]},
        {"name": "lk_track", "route": "cuda", "source": src + "lk_level.cu",
         "replaces": "uvio_tpu/frontend/pallas_kernels.py:617", "launches": launches["lk_track"],
         **kernels["lk_track"]},
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

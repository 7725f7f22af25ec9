#!/usr/bin/env python3
"""Build the port's CUDA kernels and run its raw-image -> pose step, its
UWB + SLAM filter step, its live host loop (the managers, fused and
staged), its image trackers feeding that loop, its bundle adjustment and
map backend, and the estimator configurations of `uvio_tpu`'s end-to-end
regressions on one NVIDIA GPU: the quickest proof that `uvio_tpu_torch`
works on the card.

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
              fast9 and 1 lk_track launch per step and no host sync inside
              one; median per-frame time over 2 warm repetitions; the two
              kernels' device time by name under `torch.profiler` over 5
              steps.
  8. full_step — `pipeline.full_filter_step` replays the 100 frames of the
              committed fixture (`bench.py`'s scenario: seed 7, 25 SLAM
              slots, 4 UWB anchors) on cuda:0. float64: every info equal
              to the JAX float64 replay's, position within 1e-6 m and
              trace(cov) within 1e-6 relative on every frame. float32 (with
              float64 time): cov_ok on every frame, final position within
              2 cm of the JAX float32 replay's, RMS error against ground
              truth at most the JAX one's + 2 cm, accepted ranges within 2%,
              all 25 SLAM slots full at the end; host syncs over that whole
              replay, with how many frames took each branch of the plan;
              per-frame time of 1 more, warm, replay. Its hand kernels
              are the UWB update's (`csrc/uwb_update.cu`, one launch a range
              set) and the SLAM delayed init's (`csrc/slam_init.cu`, one
              launch a frame whose plan has candidates; both counted in the
              float64 replay, all from graph replays but each key's first
              call); the phase ends by timing the first on the corridor's layout
              (D 130, float64) by the graph clock beside its bound by
              bytes, an empty one-block launch and the plain version, and
              the second against its plain version on the EuRoC cell's
              layout (D 252, 50 slots, 24 rows a candidate, camera
              calibration), its stereo layout (D 266, 48 rows) and the
              fixture's frame 3 (D 182), float64 (accepted, rejected and
              inactive candidates; `inited` equal, every float field within
              1e-10 of its largest magnitude), then by the graph clock:
              the kernel alone in its cluster and in one block, the whole
              call, the plain version, beside the bound by bytes.
  9. manager — the live host loop, `UVioManager` fed by the port's
              simulator from the first IMU sample (`eval/capture.py`:
              `bench.py`'s scenario, 120 frames, seed 7). float64: the state
              after 20 frames equals the fixture's `state0` and each of the
              next 100 bundles the fixture's (masks and indices exactly,
              floats to 1e-9), every info equals the JAX float64 replay's,
              final position within 1e-6 m. float32: the full step's float32
              gates, with the host syncs of every frame counted and the
              loop's own time (host bundle build, step from dispatch to the
              one read-back, host bookkeeping, per frame over frames
              20-119). A second configuration takes
              the branches that scenario never does (60 frames, seed 9, mono,
              no SLAM): 2 s at rest with static init and ZUPT (init fires,
              ZUPTs are accepted, the clone ring is rolled back on them),
              then, handed over by a checkpoint, motion with
              `async_dispatch`: no host sync on 31 of 32 frames, position
              within 0.5 m of ground truth. Last, a checkpoint that the JAX
              manager wrote (`fixtures/manager_ckpt_seed7.npz`) is loaded and
              run for 10 frames: poses within 1e-8 of the JAX manager's. It
              runs no hand kernel either.
 10. tracker — the image trackers, a second path to both kernels; frames are
              rendered on the host before any clock starts. (a) The hard
              rendered-image regression at full width: 187 frames of
              `render_image_hard` (752x480, seed 9, 19 s with 5 s at rest) ->
              `KLTTracker` (150 features, grid 6x8, HISTOGRAM) -> `VioManager`
              (static init + ZUPT, float64) -> posyaw ATE; gates: >= 100
              initialized frames, >= 15 tracks after frame 3, ATE < 0.15 m and
              < 2.5 deg, cov_ok on every step, exactly 1 fast9 + 1 lk_track
              launch per `feed`; printed: ms per `feed` (host clock to its one
              read-back) beside the manager's ms per frame, and, from the
              tracker alone on 12 of the frames, host syncs (exactly 1, the
              read-back) and kernel launches per `feed`. The same tracker
              output also feeds a staged twin of the manager
              (`fused_step=False`, otherwise equal; both consume the one
              `feed`'s launches) under the same gates (>= 100 initialized
              frames, ATE < 0.15 m and < 2.5 deg, cov_ok at every stage);
              printed: its ATE beside the fused one, the mean of each
              `last_timing` stage (built with tracing on: the device ms of
              the stage's graph replays), host syncs per staged frame on 5 frames,
              the largest position difference between the two, and per
              graphed stage its graphs beside the input shapes it met (gated:
              no more graphs than shapes, so none per slot value).
              (b) A stereo rig (baseline 0.11 m, seed 3)
              through `StereoKLTTracker` into a two-camera `VioManager`, 30
              frames: >= 10 stereo matches a frame, median |disparity| in
              (2, 20) px, cov_ok, final position within 0.5 m, 1 fast9 + 2
              lk_track launches per `feed` (also by the profiler's kernel
              names). (c) `DescriptorTracker`, 8 frames: >= 15 tracks a
              frame, one track of length >= 6, 1 fast9 launch per `feed` (also
              by the profiler's kernel names). In (a), (b), (c) and (e) every
              hand-kernel launch that no graph key's first call made (its
              eager warm-up) comes from a graph replay. (d) One `feed`'s
              device work through the kernels and
              through their plain versions from the same tracker state and
              RANSAC noise: FAST-9 0.0, LK masks equal and <= 3.4e-4 px, the
              same detections. (e) `KLTTracker(histeq="CLAHE")` (cv2 on the
              host) on 12 rendered 752x480 frames (seed 3): >= 20 tracks a
              frame, a track of length >= 8, median drift < 30 px, 1 fast9 (+ 1
              lk_track after the first) launch per `feed`, the first frame's
              detections equal to a CPU tracker's given the same RANSAC noise;
              and `ArucoTracker` on tests/test_torch_aruco.py:22's tag scene
              under that test's gates (cv2.aruco must be there).
 11. init   — the in-motion initializer and the dataset entry point. (a) The
              scenario of tests/test_dynamic_init.py's end-to-end test
              (seed 11, circle_trajectory(24 s, lap 8 s), 11 clones, 15 SLAM
              slots, sigma_pix 1, static + dynamic init, float64) through
              `VioManager` on the card: dynamic init fires < 5 s after the
              start, posyaw ATE < 0.25 m over the 12 s after it, cov_ok on
              every step, no solver attempt longer than 30 s (the first
              pays the process's first use of the solver's kernels and
              libraries), and the last window solved again, warm, at its
              own 10 and at the vendored configs' 50 Gauss-Newton steps in
              <= 6 s each; printed: the solver's attempts, ms per
              `solve_dynamic_init` call to its read-back, the warm ms, and
              kernel and CUDA graph launches and device kernels per call
              (profiler). (b) `run_euroc` on an ASL dataset that
              `write_synthetic_dataset` renders (seed 13, 16 s with 5 s at
              rest, 90 points, 10 Hz; the estimator settings of
              tests/test_euroc_reader.py): >= 25 poses, posyaw ATE < 0.5 m,
              exactly 1 fast9 + 1 lk_track launch per `feed` after the first
              (1 + 0 on it), the native host library built.
 12. streams — the vendored streams (`data/streams/{mono,stereo,uwb}`, 450
              frames each) through the port's `load_config` -> `VioManager` /
              `UVioManager` on the card, seeded from their `init.txt`, under
              the gates of the reference's regressions against the C++
              estimator's own output: SE(3) ATE <= `ref_est.txt`'s, and final
              anchor error <= `anchors_est.txt`'s (uwb) or orientation ATE
              <= 1.2x the reference's (mono, stereo); cov_ok on every step; ms
              per frame (`last_timing`). They run in the worker pool of phase
              15, beside its scenarios when both phases run.
 13. backend — bundle adjustment and the map backend, float64, and the
              staged managers against `uvio_tpu`. (b) The scenario of
              tests/test_map_backend.py:45 (seed 11, a 16 s circle, 50
              points, 10 Hz camera, 11 clones) through a staged `VioManager`
              into `MapBackend(every_n_frames=3, max_keyframes=48,
              lm_bucket=64)`, then `refine()`: >= 20 keyframes, the cost
              does not rise, median keyframe position error < 0.05 m against
              the ground-truth camera centres, >= 20 points with median error
              < 0.05 m. (c) `ba_solve` at the backend's full capacity: 64
              keyframes on an arc around 4096 landmarks (tests/test_ba.py's
              scene), 10 iterations, on the card and on the card machine's
              CPU: per-iteration costs within 1e-9 relative, parameters
              within 1e-8, no host sync inside the solve; printed: ms per
              solve (host clock to its one read-back, 3 warm solves), kernel
              launches per solve. (d) `bench.py`'s scenario (seed 7, 4
              anchors with online calibration, 25 SLAM slots) through the
              staged `UVioManager`, 20 warm-up frames and 60 more, against
              `uvio_tpu`'s staged run (`fixtures/staged_seed7.npz`): every
              MSCKF, SLAM and UWB decision equal, position within 1e-6 m and
              trace(cov) within 1e-6 relative on every frame, no stage with
              more graphs than input shapes; printed: the mean of each
              stage (the device ms of its graph replays: the manager is
              built with tracing on), host syncs on the last 5 frames, graphs and shapes by
              stage. None of it runs a hand kernel.
 14. batch  — B independent sequences through one batched full step
              (`pipeline.make_batched_full_step`, `torch.func.vmap` of the
              full step), on the committed fixture `fixtures/batched_seeds.npz`:
              `bench.py`'s scenario under seeds 7-10, each after its own
              warm-up, so the four plans differ in UWB rows, SLAM init and
              marginalization. (a) float64: every info of every sequence and
              frame equal to `uvio_tpu`'s `jax.vmap(full_filter_step)`
              replay, position within 1e-6 m and trace(cov) within 1e-6
              relative. (b) float32 (float64 time): cov_ok on every frame of
              every sequence, each final position within 2 cm of JAX
              float32's. (c) float32, the four sequences tiled to B = 1, 8,
              32: a warm pass over the 20 timed frames (it captures the graphs
              they need), then the 20 timed frames (and the
              single step on sequence 0's frames by the same clock); per B
              ms per batched step (host clock to a synchronize), sequence-
              frames/s, kernel launches of one step (profiler), host syncs
              in one step (gated at 0), peak device memory; and the
              operations vmap runs as a per-sample loop (its fallback
              warnings). (d) `examples/profile_step_torch.py` and
              `examples/scaling_torch.py` as two subprocesses side by side,
              at reduced repetitions: exit code 0, their JSON lines echoed.
              It runs no hand kernel.
 15. estimator — the sixteen scenarios of `uvio_tpu`'s slow end-to-end
              regressions (tests/torch_e2e_scenarios.py: mono MSCKF with NEES,
              SLAM beating MSCKF-only, stereo, the six SLAM representations,
              the camera-IMU time offset, online extrinsics, the discrete and
              analytical integrators, IMU intrinsics seeded and calibrated,
              UWB) through the live managers on cuda:0 in float64, with the
              reference tests' own gates; up to 6 spawned workers side by
              side (one host thread and CUDA context each; the count follows
              the host's cores and is printed). Printed per case: ATE, the
              gate, frames, the manager's ms per frame (`last_timing`,
              median; shared host), host syncs per frame of the manager's
              calls on frames 20-24, and the final calibration error beside
              its start where one is estimated. Any failed case fails the
              run. It runs no hand kernel (the features come from the
              simulator).
The steps run as `uvio_tpu_torch` runs them on the card: each graphed
(`uvio_tpu_torch/graphs.py`, the port's `jax.jit`), one CUDA graph replay
a frame for every key already captured, the hand kernels inside the
graphs, their launches counted at each replay. Phases slice, full_step,
manager, tracker (a), its staged twin, (b) and (c), backend (d) and its
IMU-rate poses (`get_propagated_pose`), batch and estimator also print a
"compiled step" line each: the eager step against the graphed one in ms a
frame by the host clock, alternated eager, graphed, graphed, eager;
launch calls, graph launches, memcpy calls and device kernels of one step
of each by the profiler; the graphs captured, their warm-up and capture
ms and the memory their pools hold. The slice and tracker (a) also hold
the hand kernels to one `fast9` and one `lk_track` a step or `feed` by
the profiler's kernel names, beside the replay count.
Then the kernel table (with each kernel's bound: the larger of its bytes
over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted from
this run's inputs; `launches` summed over the slice, the tracker runs and
`run_euroc`, `launches_by_path` for each and `replay_launches_by_path`,
those of them from graph replays), the `nvidia-smi` line, and the
result line. Needs no network; any failed check raises.

    python3 chip_smoke.py --phases init,streams

runs only the named phases (comma list of kernels, slice, full_step,
manager, tracker, init, streams, backend, batch, estimator; default all): the card and build phases
always run, and the kernel table is printed only with `kernels`.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
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
    (state, info) after each; steps(eager=True) runs the eager step."""
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

    def steps(eager=False):
        gen = torch.Generator(device=dev).manual_seed(0)
        st, carry = st0, make_carry(frames[0])
        run = step.eager if eager else step
        for i, (t, w, a, ts) in enumerate(windows):
            st, carry, info = run(st, carry, frames[i + 1], t, w, a, ts, generator=gen)
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
        """(run, fx, plans, step): run() replays every frame through
        `step` (or `fn`, over the first `n` frames), synchronizes (unless
        told not to) and returns per-frame device results."""
        fx, step, plans, bundles, st0 = full_step_inputs(dev, dtype)

        def run(sync=True, fn=step, n=None):
            st, out = st0, []
            for fb, plan in list(zip(bundles, plans))[:n]:
                st, info = fn(st, fb, plan)
                out.append((st.p, st.cov.trace(), info))
            if sync:
                torch.cuda.synchronize()
            return st, out

        return run, fx, plans, step

    # ---- float64: the same decisions as the JAX float64 replay, with the
    # UWB kernel's launches counted over it --------
    from uvio_tpu_torch.frontend import kernels as K

    run64, fx, plans64, step64 = replay(torch.float64)
    n = len(fx.bundles)
    K.reset_launch_counts()
    rows = []
    st, out = counted(K, [step64], run64, rows)
    uwb_rec, uwb_ok = uwb_launch_record(rows, sum(sum(p.uwb_rows) for p in plans64))
    init_rec, init_ok = slam_init_launch_record(rows, sum(p.slam_init for p in plans64))
    msckf_rec, msckf_ok = msckf_launch_record(rows, n)
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
             "max_p_diff_m": p_err, "max_trace_rel_diff": tr_err, **uwb_rec, **init_rec, **msckf_rec}
    log(rec64)
    if bad or not (p_err <= 1e-6 and tr_err <= 1e-6):
        for b in bad:
            log(b)
        raise RuntimeError("full_step float64 disagrees with the JAX float64 replay")
    if not uwb_ok:
        raise RuntimeError("full_step float64: not one UWB kernel launch a range set, all from replays")
    if not init_ok:
        raise RuntimeError("full_step float64: not one SLAM init kernel launch a frame with candidates, "
                           "all from replays")
    if not msckf_ok:
        raise RuntimeError("full_step float64: not one MSCKF update kernel launch a frame, all from replays")

    # ---- float32: the bench precision, held to the JAX float32 replay; the
    # same replay counts what waits for the host inside the steps: nothing
    # should, over a whole replay, which takes every branch of the plan
    run32, fx, plans, step32 = replay(torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st, out = run32(sync=False)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
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

    branches = {"uwb_rows_run": sum(sum(p.uwb_rows) for p in plans),
                "uwb_rows_skipped": sum(len(p.uwb_rows) - sum(p.uwb_rows) for p in plans),
                "slam_init_frames": sum(p.slam_init for p in plans),
                "marg_frames": sum(p.marg for p in plans),
                "slam_init_and_marg_frames": sum(p.slam_init and p.marg for p in plans),
                "zupt_try_frames": sum(p.zupt_try for p in plans)}
    reps = []
    for _ in range(1):
        t0 = time.perf_counter()
        run32()
        reps.append((time.perf_counter() - t0) / n * 1e3)
    rec32.update({"per_frame_ms_median": statistics.median(reps), "per_frame_ms_reps": reps,
                  "host_syncs_in_replay": len(caught), "replay_plans": branches,
                  "sync_sources": sorted({str(w.message).split("\n")[0][:120] for w in caught}),
                  "card": card})
    log(rec32)

    # ---- the compiled step: eager against graphed over 40 frames -------
    def ms_per_frame(fn, n=40):
        t0 = time.perf_counter()
        run32(fn=fn, n=n)
        return (time.perf_counter() - t0) / n * 1e3

    timing = abba(lambda: ms_per_frame(step32.eager), lambda: ms_per_frame(step32))
    fx32, _, plans32, bundles32, st32 = full_step_inputs(dev, torch.float32)
    one = lambda fn: lambda: fn(st32, bundles32[30], plans32[30])
    compiled_step_line("full_step", "full_filter_step, float32", card, [step32], timing,
                       {"eager": launch_profile(one(step32.eager)), "graphed": launch_profile(one(step32))},
                       distinct_plans=len(set(plans)), graphs_float64=step64.stats()["graphs"])
    if not step32.stats()["graphs"] == step64.stats()["graphs"] == len(set(plans)):
        raise RuntimeError(f"{step32.stats()['graphs']} and {step64.stats()['graphs']} graphs captured for "
                           f"{len(set(plans))} distinct plans")
    uwb_kernel_timing(dev, card)
    slam_init_kernel_timing(dev, card)
    msckf_kernel_timing(dev, card)


def uwb_kernel_timing(dev, card):
    """The UWB range-update kernel (`csrc/uwb_update.cu`) on the corridor's
    layout (D 130, 8 anchor slots, 4 anchors, the lever arm; a state of the
    benchmark scenario after 6 frames, float64, with its next range set): by
    the graph clock beside its bound by bytes (the covariance read and
    written once), an empty one-block launch and the plain version
    `uwb_update_ref`; the kernel's result against the plain one's."""
    import numpy as np
    import torch

    from uvio_tpu_torch import _build
    from uvio_tpu_torch.eval.capture import bench_scenario, drive
    from uvio_tpu_torch.types.state import state_from_numpy, state_to_numpy
    from uvio_tpu_torch.update import uwb

    sim, mgr = bench_scenario(8, seed=7, max_slam=0, dtype="float64", device="cpu", max_anchors=8,
                              calib_uwb_extrinsics=True, p_IinU=np.array([0.05, -0.02, 0.1]))
    fed = []
    feed = mgr.feed_uwb
    mgr.feed_uwb = lambda t, r: (fed.append(r), feed(t, r))
    snap = []
    drive(sim, mgr, 7, on_frame=lambda k, t: snap.append((len(fed), state_to_numpy(mgr.state))) if k == 5 else None)
    L, (n, arrays) = mgr.layout, snap[0]
    ranges, mask = np.zeros(L.max_anchors), np.zeros(L.max_anchors, bool)
    for aid, d in fed[n].items():
        ranges[mgr.anchor_slot_by_id[aid]], mask[mgr.anchor_slot_by_id[aid]] = d, True
    st = state_from_numpy(arrays, dev)
    r, m = torch.as_tensor(ranges, device=dev), torch.as_tensor(mask, device=dev)
    sigma = mgr.ucfg.sigma_range
    got, gi = uwb.uwb_update(st, L, r, m, sigma_range=sigma)
    want, wi = uwb.uwb_update_ref(st, L, r, m, sigma_range=sigma)
    cov_err = float((got.cov - want.cov).abs().max() / want.cov.abs().max())
    p_err = float((got.p - want.p).abs().max())
    if not (torch.equal(gi["accepted"], wi["accepted"]) and cov_err <= 1e-12 and p_err <= 1e-12):
        raise RuntimeError(f"uwb_update kernel against plain: accepted {gi['accepted'].tolist()} and "
                           f"{wi['accepted'].tolist()}, cov {cov_err:.3g}, p {p_err:.3g}")
    lib = _build.load()
    cov_bytes = 2 * L.dim * L.dim * 8
    rec = {"phase": "full_step", "part": "uwb_update kernel, corridor layout, float64", "dim": L.dim,
           "anchor_slots": L.max_anchors, "ranges": int(mask.sum()), "accepted": int(gi["accepted"].sum()),
           "shared_memory": uwb.uses_shared_memory(L, torch.float64),
           "ms": graph_ms(lambda: uwb.uwb_update(st, L, r, m, sigma_range=sigma)),
           "plain_ms": graph_ms(lambda: uwb.uwb_update_ref(st, L, r, m, sigma_range=sigma), k=5, replays=10),
           "empty_one_block_ms": graph_ms(lambda: _checked(lib.uvio_empty_launch(1, 1, 512, _stream()),
                                                           "uvio_empty_launch")),
           "bound_ms": cov_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": cov_bytes,
           "ms_by_valid_ranges": {n: graph_ms(lambda: uwb.uwb_update(st, L, r, m & (torch.cumsum(m, 0) <= n),
                                                                    sigma_range=sigma)) for n in (0, 1, 2)},
           "library_ms": None, "max_cov_rel_diff": cov_err, "max_p_diff_m": p_err, "card": card}
    log(rec)
    return rec


def slam_init_kernel_timing(dev, card):
    """The SLAM delayed-init kernel (`csrc/slam_init.cu`) against its plain
    version `slam_delayed_init_ref` on the EuRoC cell's layout, its stereo
    layout and the replay fixture's frame 3 (the states of
    tests/test_torch_slam_init_kernel.py: 8 candidates, of which the
    cell's reject an outlier, an inactive row and a short track), float64;
    then by the graph clock the kernel alone (its recorded launch, in its
    cluster and in one block), the whole call (the batched part too) and
    the plain version, beside the bound by bytes (the covariance read and
    written once). One line a layout."""
    import dataclasses

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_slam_init_kernel import cell_case, fixture_case

    from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy
    from uvio_tpu_torch.update import slam
    from uvio_tpu_torch.update.representations import ANCHORED_MSCKF_INVERSE_DEPTH as rep

    def launch_args(call):
        seen, launch = [], slam._launch
        slam._launch = lambda batch, *a: (seen.append(a), launch(batch, *a))[1]
        try:
            call()
        finally:
            slam._launch = launch
        return seen[0]

    recs = []
    for name, case in (("cell", cell_case(rep)), ("stereo", cell_case(rep, cams=2)), ("fixture", fixture_case(rep))):
        c = dataclasses.replace(case, state=state_from_numpy(state_to_numpy(case.state), dev), uv=case.uv.to(dev),
                                mask=case.mask.to(dev), slots=case.slots.to(dev), ids=case.ids.to(dev))
        L = c.layout
        call = lambda: slam.slam_delayed_init(*c.args(), sigma_pix=c.sigma_pix)
        plain = lambda: slam.slam_delayed_init_ref(*c.args(), sigma_pix=c.sigma_pix)
        (got, gi), (want, wi) = call(), plain()
        errs = {}
        for f in FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            if x.dtype.is_floating_point and x.numel():
                errs[f] = float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)
            elif not torch.equal(x, y):
                errs[f] = float("inf")
        worst = max(errs, key=errs.get)
        if not (torch.equal(gi["inited"], wi["inited"]) and errs[worst] <= 1e-10):
            raise RuntimeError(f"slam_init kernel against plain, {name}: inited {gi['inited'].tolist()} and "
                               f"{wi['inited'].tolist()}, {worst} {errs[worst]:.3g}")
        args = launch_args(call)
        size = slam.cluster_size
        slam.cluster_size = lambda Fc: 1
        try:
            one = launch_args(call)
        finally:
            slam.cluster_size = size
        cov_bytes = 2 * L.dim * L.dim * 8
        kernel_ms = graph_ms(lambda: slam._launch(1, *args))
        bound = cov_bytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "full_step", "part": f"slam_init kernel, {name} layout, float64", "dim": L.dim,
               "max_slam": L.max_slam, "rows": 2 * L.max_clones * L.num_cams, "candidates": int((c.ids >= 0).sum()),
               "inited": int(gi["inited"].sum()), "cluster": slam.cluster_size(c.ids.shape[0]),
               "kernel_ms": kernel_ms, "kernel_one_block_ms": graph_ms(lambda: slam._launch(1, *one)),
               "ms": graph_ms(call, k=10, replays=5), "plain_ms": graph_ms(plain, k=5, replays=5),
               "bound_ms": bound, "bound_by": "bytes", "bytes": cov_bytes, "bound_share_pct": bound / kernel_ms * 100,
               "max_cov_rel_diff": errs["cov"], "max_slam_p_rel_diff": errs["slam_p"],
               "max_rel_diff": errs[worst], "max_rel_diff_field": worst, "card": card}
        log(rec)
        recs.append(rec)
    return recs


def msckf_kernel_timing(dev, card):
    """The MSCKF update kernel (`csrc/msckf_update.cu`) against its plain
    version `msckf_update_ref` on the corridor cell's layout, the EuRoC
    cell's, its stereo layout and the replay fixture's frame 3 (the states
    of tests/test_torch_msckf_kernel.py: 40 features of which an outlier,
    one seen once and a padding row fail), float64; then by the graph clock
    the kernel alone (its recorded launch), the whole call (triangulation
    and the Jacobians too) and the plain version, beside the bound by bytes
    (the covariance read and written once, the live stacked systems read
    once). One line a layout."""
    import dataclasses

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_msckf_kernel import fixture_case, layout_case

    from uvio_tpu_torch.types.state import FIELDS, state_from_numpy, state_to_numpy
    from uvio_tpu_torch.update import msckf

    def launch_args(call):
        seen, launch = [], msckf._launch
        msckf._launch = lambda batch, *a: (seen.append(a), launch(batch, *a))[1]
        try:
            call()
        finally:
            msckf._launch = launch
        return seen[0]

    recs = []
    for name in ("corridor", "euroc", "stereo", "fixture"):
        case = fixture_case() if name == "fixture" else layout_case(name)
        c = dataclasses.replace(case, state=state_from_numpy(state_to_numpy(case.state), dev), uv=case.uv.to(dev),
                                mask=case.mask.to(dev))
        L = c.layout
        call = lambda: msckf.msckf_update(*c.args(), sigma_pix=c.sigma_pix)  # noqa: E731
        plain = lambda: msckf.msckf_update_ref(*c.args(), sigma_pix=c.sigma_pix)  # noqa: E731
        (got, gi), (want, wi) = call(), plain()
        errs = {}
        for f in FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            if x.dtype.is_floating_point and x.numel():
                errs[f] = float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)
            elif not torch.equal(x, y):
                errs[f] = float("inf")
        worst = max(errs, key=errs.get)
        same = all(torch.equal(gi[k], wi[k]) for k in ("tri_ok", "kept", "num_used", "cov_ok"))
        if not (same and errs[worst] <= 1e-10):
            raise RuntimeError(f"msckf_update kernel against plain, {name}: kept {gi['kept'].tolist()} and "
                               f"{wi['kept'].tolist()}, {worst} {errs[worst]:.3g}")
        args = launch_args(call)
        F, M, W = c.uv.shape[0], 2 * L.max_clones * L.num_cams, L.slam_off - L.calib_off
        nbytes = (2 * L.dim * L.dim + F * M * (W + 4)) * 8
        kernel_ms = graph_ms(lambda: msckf._launch(1, *args))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "full_step", "part": f"msckf_update kernel, {name} layout, float64", "dim": L.dim,
               "features": F, "rows": M, "live_columns": W, "kept": int(gi["num_used"]),
               "kernel_ms": kernel_ms, "ms": graph_ms(call, k=10, replays=5), "plain_ms": graph_ms(plain, k=5, replays=5),
               "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes, "bound_share_pct": bound / kernel_ms * 100,
               "max_cov_rel_diff": errs["cov"], "max_rel_diff": errs[worst], "max_rel_diff_field": worst,
               "card": card}
        log(rec)
        recs.append(rec)
    return recs


class SyncCounter:
    """Counts, frame by frame, the host syncs that
    `torch.cuda.set_sync_debug_mode("warn")` reports while a manager is
    driven: `on_frame` is the drive loop's callback, `per_frame[k]` the
    syncs of frame k's `feed_features` and of the IMU and UWB feeding
    before it, `sources` the distinct warnings. (Turning the mode on warns
    once that it is a prototype; that warning is no sync and is not counted.)"""

    def __enter__(self):
        import warnings

        import torch

        self._ctx = warnings.catch_warnings(record=True)
        self._caught = self._ctx.__enter__()
        warnings.simplefilter("always")
        self.per_frame, self._seen = [], 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _syncs(self):
        return [str(w.message) for w in self._caught if "synchronizing CUDA operation" in str(w.message)]

    def on_frame(self, k, t):
        n = len(self._syncs())
        self.per_frame.append(n - self._seen)
        self._seen = n

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        self.sources = sorted({m.split("\n")[0][:120] for m in self._syncs()})
        self._ctx.__exit__(*exc)
        torch.cuda.synchronize()


def manager_phase(dev, card):
    """The live host loop on the card (module docstring, phase 9)."""
    manager_bench_scenario(dev, card)
    manager_rest_then_async(card)
    manager_jax_checkpoint(card)


def manager_bench_scenario(dev, card):
    """`bench.py`'s scenario live: float64 against the fixture, float32
    against its gates with the syncs counted, then the loop's own time."""
    import numpy as np
    import torch

    from uvio_tpu_torch.eval.capture import bench_scenario, record_live
    from uvio_tpu_torch.fixtures import load_full_step_fixture
    from uvio_tpu_torch.pipeline import FrameBundle
    from uvio_tpu_torch.types.state import FIELDS

    fx = load_full_step_fixture()
    n_warm, n = 20, len(fx.bundles)
    exact = lambda ref: ref.dtype == bool or np.issubdtype(ref.dtype, np.integer)

    def worst_diff(got, ref, names, what):
        """Max abs float difference over `names`; masks and integers must
        be equal."""
        worst = 0.0
        for name in names:
            a, b = np.asarray(got[name]), np.asarray(ref[name])
            if a.shape != b.shape or (exact(b) and not np.array_equal(a, b)):
                raise RuntimeError(f"manager float64: {what} differs from the fixture in {name}")
            if not exact(b) and a.size:
                worst = max(worst, float(np.abs(a - b).max()))
        return worst

    # ---- float64, live: the fixture's state0, bundles and decisions, with
    # the UWB kernel's launches counted over the whole run -----
    sim, mgr = bench_scenario(n_warm + n, seed=7, max_slam=25, dtype="float64")
    if mgr.state.cov.device != dev:
        raise RuntimeError(f"the manager's state is on {mgr.state.cov.device}, not {dev}")
    rec, uwb_rec, uwb_ok = manager_uwb_counted(mgr, lambda: record_live(sim, mgr, n_warm + n, snapshot_at=n_warm))
    torch.cuda.synchronize()
    state_diff = worst_diff(rec["snapshot"], fx.state0, FIELDS, "the state after 20 frames")
    bundle_diff, first_bad = 0.0, None
    for k, (b, ref_b) in enumerate(zip(rec["bundles"][n_warm:], fx.bundles)):
        d = worst_diff(b, ref_b, FrameBundle._fields, f"bundle {k}")
        if d > 1e-9 and first_bad is None:
            first_bad = k
        bundle_diff = max(bundle_diff, d)
    ref = fx.replays["f64"]
    bad = []
    for k, info in enumerate(rec["infos"][n_warm:]):
        got = _frame_infos(info)
        diff = [key for key, v in got.items() if not np.array_equal(v, ref[key][k])]
        if diff:
            bad.append({"frame": k, "differs": diff})
    final_diff = float(np.linalg.norm(mgr.get_pose()[1] - ref["p"][-1]))
    rec64 = {"phase": "manager", "precision": "float64", "frames": n_warm + n,
             "steps": len(rec["bundles"]), "state0_max_diff": state_diff,
             "bundles_max_diff": bundle_diff, "infos_equal_all": not bad,
             "final_p_diff_vs_jax_m": final_diff, "time_host_is_state_time":
             mgr._time_host == float(mgr.state.time), **uwb_rec, "card": card}
    log(rec64)
    if (len(rec["bundles"]) != n_warm + n or state_diff > 1e-9 or bundle_diff > 1e-9 or bad
            or final_diff > 1e-6 or not rec64["time_host_is_state_time"]):
        log({"first_bundle_past_1e-9": first_bad, "infos_differ": bad[:10]})
        raise RuntimeError("the live float64 loop does not reproduce the fixture")
    if not uwb_ok:
        raise RuntimeError("the live float64 loop: not one UWB kernel launch a range set, all from replays")
    step64 = mgr.full_step

    # ---- float32, live: accuracy gates, with every frame's syncs counted
    def live32(**kw):
        sim, mgr = bench_scenario(n_warm + n, seed=7, max_slam=25, dtype="float32")
        t0 = time.perf_counter()
        rec = record_live(sim, mgr, n_warm + n, **kw)
        torch.cuda.synchronize()
        return mgr, rec, time.perf_counter() - t0

    with SyncCounter() as syncs:
        mgr, rec, wall = live32(on_frame=syncs.on_frame)
    ref = fx.replays["f32"]
    p = np.stack([x.cpu().numpy() for x in rec["p"][n_warm:]]).astype(np.float64)
    cov_ok = [bool(i["cov_ok"].item()) for i in rec["infos"]]
    uwb = sum(int(i["uwb_accepted"].sum().item()) for i in rec["infos"][n_warm:])
    uwb_ref = int(ref["uwb_accepted"].sum())
    rms = float(np.sqrt(np.mean(np.sum((p - fx.gt_p) ** 2, axis=1))))
    rms_ref = float(np.sqrt(np.mean(np.sum((ref["p"] - fx.gt_p) ** 2, axis=1))))
    slots = int(mgr.state.slam_valid.sum().item())
    bench_syncs = syncs.per_frame[n_warm:]
    rec32 = {"phase": "manager", "precision": "float32", "frames": n_warm + n,
             "cov_ok_all": all(cov_ok), "rms_p_err_m": rms, "rms_p_err_jax_m": rms_ref,
             "uwb_accepted": uwb, "uwb_accepted_jax": uwb_ref, "slam_slots_end": slots,
             "host_syncs_per_frame_median": statistics.median(bench_syncs),
             "host_syncs_per_frame_max": max(bench_syncs),
             "frames_with_one_sync": sum(x == 1 for x in bench_syncs),
             "sync_sources": syncs.sources}
    if not (all(cov_ok) and len(cov_ok) == n_warm + n and rms <= rms_ref + 0.02
            and abs(uwb - uwb_ref) <= 0.02 * uwb_ref and slots == fx.config["layout"]["max_slam"]):
        log(rec32)
        raise RuntimeError("the live float32 loop failed its gates")

    # ---- the loop's own time, frames 20-119 of the same run (the sync
    # counter adds one recorded warning a frame, at the read-back) ---------
    rows = rec["timings"][n_warm:]
    mean_ms = lambda key: 1e3 * sum(row[key] for row in rows) / len(rows)
    rec32.update({"build_ms": mean_ms("uwb"), "step_ms": mean_ms("propagation"),
                  "bookkeeping_ms": mean_ms("marginalization"), "total_ms": mean_ms("total"),
                  "wall_ms_per_frame_all_120": 1e3 * wall / (n_warm + n), "card": card})
    log(rec32)

    # ---- the compiled step: frames 20-39 of the live float32 loop with the
    # graphed step and with the eager one; both managers take the gated
    # run's graphed step and stages (the landmark drop is one), so no
    # frame timed here captures
    from uvio_tpu_torch.eval.capture import drive

    shared = mgr.full_step

    def live_ms(eager, frames=40):
        sim_t, m = bench_scenario(n_warm + n, seed=7, max_slam=25, dtype="float32")
        m.full_step = shared.eager if eager else shared
        share_stages(m, mgr, eager=eager)
        totals = []
        drive(sim_t, m, frames, on_frame=lambda k, t: k >= n_warm and totals.append(m.last_timing["total"]))
        return 1e3 * statistics.fmean(totals)

    timing = abba(lambda: live_ms(True), lambda: live_ms(False))
    fields, t_before = rec["bundles"][-1], float(rec["bundles"][-2]["stamp_time"])

    def one_frame(fn):
        def run():
            m_step, saved = mgr.full_step, mgr._time_host
            mgr.full_step, mgr._time_host = fn, t_before
            try:
                mgr._jit_full(mgr.state, fields)
            finally:
                mgr.full_step, mgr._time_host = m_step, saved
        return run

    compiled_step_line("manager", "UVioManager live frame (build + step + bookkeeping), float32, bench.py's "
                       "scenario", card, [shared], timing,
                       {"eager": launch_profile(one_frame(shared.eager)), "graphed": launch_profile(one_frame(shared))},
                       graphs_float64=step64.stats()["graphs"], pool_mb_float64=step64.stats()["pool_bytes"] / 2**20)


def manager_uwb_counted(mgr, run):
    """(run(), `uwb_launch_record`'s record and verdict) with the hand
    kernels' counts reset first: a range set is a UWB row that the fused
    step's plan runs (`pipeline.plan_frame`) or one drained by the staged
    stage `_stage_uwb` (when more sets wait than the step takes)."""
    import uvio_tpu_torch.manager as M
    from uvio_tpu_torch.frontend import kernels as K

    sets, plan, stage = [0], M.plan_frame, mgr._stage_uwb

    def planned(*args):
        p = plan(*args)
        sets[0] += sum(p.uwb_rows)
        return p

    def staged(*args, **kw):
        sets[0] += 1
        return stage(*args, **kw)

    graphs = [getattr(mgr, name) for name in ("full_step", *stage_names(mgr)) if hasattr(mgr, name)]
    M.plan_frame, mgr._stage_uwb = planned, staged
    K.reset_launch_counts()
    rows = []
    try:
        out = counted(K, graphs, run, rows)
    finally:
        M.plan_frame, mgr._stage_uwb = plan, stage
    return (out, *uwb_launch_record(rows, sets[0]))


def manager_rest_then_async(card):
    """60 frames, seed 9, mono, no SLAM: 2 s at rest under a manager with
    static init and ZUPT, then, handed over by a checkpoint, motion under
    one with `async_dispatch`."""
    import numpy as np
    import torch

    from uvio_tpu_torch.eval.capture import drive
    from uvio_tpu_torch.init.static_init import StaticInitOptions
    from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager
    from uvio_tpu_torch.math import quat_to_rot
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory
    from uvio_tpu_torch.types.state import FIELDS

    still = 2.0
    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=60, seed=9),
                    trajectory=circle_trajectory(duration=6.0 + 8.0, still_time=still))
    cam = sim.params.cameras[0]
    base = dict(max_clones=11, max_slam=0, sigma_pix=sim.params.sigma_pix, dtype="float32",
                cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics,
                                      q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)])
    rest = VioManager(VioConfig(use_static_init=True, try_zupt=True, zupt_max_disparity=3.0,
                                init_options=StaticInitOptions(window_time=1.0, imu_thresh=0.1), **base))
    n_rest = int(round((still + 0.4 - sim.t_start) * 10))  # frames until 0.4 s into the motion
    zupt_rec = {"accepted": 0, "rolled_back": 0, "tried": 0, "init_frame": None}
    full = rest._jit_full

    def zupt_hook(state, fields):
        out = full(state, fields)
        zupt_rec["tried"] += int(fields["zupt_try"])
        zupt_rec["_last"] = out[1]["zupt_accepted"]
        return out

    rest._jit_full = zupt_hook

    def after_rest_frame(k, t):
        if rest.is_initialized and zupt_rec["init_frame"] is None:
            zupt_rec["init_frame"] = k
        acc = zupt_rec.pop("_last", None)
        if acc is not None and bool(acc.item()):
            # no clone on a frozen frame: the host's ring is again the
            # device's, and the state time moved to the frame's
            valid = rest.state.clones_valid.cpu().numpy()
            device_ring = {int(k): float(v) for k, v in zip(np.nonzero(valid)[0],
                                                            rest.state.clones_t.cpu().numpy()[valid])}
            zupt_rec["accepted"] += 1
            zupt_rec["rolled_back"] += int(rest.slot_times == device_ring and t not in device_ring.values()
                                           and rest._time_host == t == float(rest.state.time))

    drive(sim, rest, n_rest, on_frame=after_rest_frame)
    rest._jit_full = full
    if not rest.is_initialized:
        raise RuntimeError("static initialization did not fire at rest")
    t_init, q_init, p_init = rest.init_replay_rows[0]
    moving = VioManager(VioConfig(async_dispatch=True, **base))
    with tempfile.TemporaryDirectory() as tmp:
        rest.save_checkpoint(os.path.join(tmp, "handover.npz"))
        moving.load_checkpoint(os.path.join(tmp, "handover.npz"))
    handed = all(torch.equal(getattr(rest.state, f), getattr(moving.state, f)) for f in FIELDS)
    n_async = 60 - n_rest
    with SyncCounter() as syncs:
        drive(sim, moving, n_async, on_frame=syncs.on_frame)
    per_frame = syncs.per_frame
    # the estimate lives in the frame static init chose (origin at the init
    # pose, its own yaw): map it into the simulator's by the init pose
    t_end = moving._time_host
    g_i, g_e = sim.get_gt_state(t_init), sim.get_gt_state(t_end)
    R_align = (quat_to_rot(torch.as_tensor(g_i["q_GtoI"])).T @ quat_to_rot(torch.as_tensor(q_init))).numpy()
    p_est = R_align @ (moving.get_pose()[1].astype(np.float64) - p_init) + g_i["p_IinG"]
    p_err = float(np.linalg.norm(p_est - g_e["p_IinG"]))
    moved = float(np.linalg.norm(g_e["p_IinG"] - g_i["p_IinG"]))
    finite = bool(torch.isfinite(moving.state.cov).all().item())
    rec2 = {"phase": "manager", "config": "mono, seed 9, static init + ZUPT at rest, then async",
            "frames": n_rest + n_async, "rest_frames": n_rest, "static_init_at_frame":
            zupt_rec["init_frame"], "zupt_tried": zupt_rec["tried"], "zupt_accepted":
            zupt_rec["accepted"], "zupt_ring_rolled_back": zupt_rec["rolled_back"],
            "checkpoint_handover_bit_equal": handed, "async_frames": n_async,
            "async_syncs_per_frame": per_frame, "async_frames_without_sync":
            sum(x == 0 for x in per_frame), "async_sync_sources": syncs.sources,
            "deferred_checks": n_async // 32, "final_p_err_m": p_err, "path_length_m": moved,
            "cov_finite": finite, "time_host_is_state_time": t_end == float(moving.state.time),
            "card": card}
    log(rec2)
    ok_syncs = all((x == 0) if (i + 1) % 32 else (x >= 1) for i, x in enumerate(per_frame))
    if not (zupt_rec["accepted"] >= 1
            and zupt_rec["rolled_back"] == zupt_rec["accepted"] and handed and ok_syncs
            and n_async >= 32 and p_err < 0.5 and moved > 1.0 and finite
            and rec2["time_host_is_state_time"] and len(per_frame) == n_async):
        raise RuntimeError("the static-init / ZUPT / async configuration failed its gates")


def manager_jax_checkpoint(card):
    """The checkpoint that the JAX manager wrote after frame 20 of
    `bench.py`'s scenario, loaded and run on for 10 frames."""
    import numpy as np

    from uvio_tpu_torch.eval.capture import bench_scenario, drive
    from uvio_tpu_torch.fixtures import MANAGER_CKPT_FIXTURE, load_manager_ckpt_reference

    ref = load_manager_ckpt_reference()
    sim, mgr = bench_scenario(120, seed=7, max_slam=25, dtype="float64")  # the fixture's simulator
    drive(sim, None, 20)  # the simulator alone, to where the checkpoint was taken
    mgr.load_checkpoint(MANAGER_CKPT_FIXTURE)
    poses = []
    drive(sim, mgr, len(ref["ref_t"]), on_frame=lambda k, t: poses.append((t, *mgr.get_pose())))
    t_same = all(t == rt for (t, _, _), rt in zip(poses, ref["ref_t"]))
    q_diff = max(float(np.abs(q - rq).max()) for (_, q, _), rq in zip(poses, ref["ref_q"]))
    p_diff = max(float(np.abs(p - rp).max()) for (_, _, p), rp in zip(poses, ref["ref_p"]))
    rec3 = {"phase": "manager", "config": "checkpoint written by the JAX manager after frame 20",
            "frames": len(poses), "stamps_equal": t_same, "max_q_diff": q_diff, "max_p_diff_m": p_diff,
            "slam_landmarks_restored": len(mgr.slam_slot_by_fid), "card": card}
    log(rec3)
    if not (len(poses) == len(ref["ref_t"]) and t_same and q_diff <= 1e-8 and p_diff <= 1e-8):
        raise RuntimeError("the restored JAX checkpoint does not reproduce the JAX manager's poses")


def kernel_launches(run):
    """(kernel launches of any kind, CUDA graph launches, kernels run on
    the device with graph nodes included) that run() makes
    (`launch_profile`)."""
    p = launch_profile(run)
    return int(p["kernel_launch_calls"]), int(p["graph_launches"]), int(p["device_kernels"])


WARM_KERNELS = 32


def launch_profile(run, steps=1):
    """Per step of run(), which runs `steps` steps, from `torch.profiler`'s
    CUDA events (no operator events: they cost the host more than the
    launches in a run of ~10^5 small operators, and the raw events, not
    `key_averages()`, which is slow over them): kernel launch calls, CUDA
    graph launches, memcpy calls (the copies in and out of a graph among
    them), kernels run on the device (graph nodes included), and the hand
    kernels run on the device by name.

    Late in a long process the profiler drops the first few device records
    of a trace (8 after ~90 s of the tracker phase, the `fast9` kernel that
    opens a `DescriptorTracker.feed` among them), while every API record
    arrives: `WARM_KERNELS` spin kernels open the trace to absorb the loss,
    and neither they nor their launch calls are counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    keys = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA and "spin_kernel" not in e.name()]
    return {"kernel_launch_calls": (sum(e.name() in keys for e in events) - WARM_KERNELS) / steps,
            "graph_launches": sum(e.name() == "cudaGraphLaunch" for e in events) / steps,
            "memcpy_calls": sum(e.name().startswith("cudaMemcpy") for e in events) / steps,
            "device_kernels": sum(not e.name().startswith(("Memcpy", "Memset")) for e in device) / steps,
            "hand_kernels": {n: sum(f"::{n}" in e.name() for e in device) / steps
                             for n in ("fast9_kernel", "lk_kernel", "lk_level_kernel")}}


def abba(run_eager, run_graphed):
    """ms a frame of the eager and the graphed path (each run returns its
    ms a frame over the same frames), alternated eager, graphed, graphed,
    eager, host clock."""
    out = {"eager_ms": [], "graphed_ms": []}
    for key, run in (("eager_ms", run_eager), ("graphed_ms", run_graphed), ("graphed_ms", run_graphed),
                     ("eager_ms", run_eager)):
        out[key].append(run())
    return out


def compiled_step_line(phase, part, card, graphed, timing=None, launches=None, **extra):
    """The line of the compiled-step layer (`graphs.graphed`) for one path:
    eager against graphed ms a frame (`abba`), launches a step of each
    (`launch_profile`), and the graphs of the `graphed` callables: how
    many, their warm-up and capture ms, the memory their pools hold."""
    stats = [g.stats() for g in graphed]
    rec = {"phase": phase, "part": part, "layer": "compiled step"}
    if timing is not None:
        rec.update({"eager_ms_per_frame": timing["eager_ms"], "graphed_ms_per_frame": timing["graphed_ms"],
                    "eager_ms_median": statistics.median(timing["eager_ms"]),
                    "graphed_ms_median": statistics.median(timing["graphed_ms"])})
    if launches is not None:
        rec["launches_per_step"] = launches
    rec.update({"graphs": sum(x["graphs"] for x in stats), "warmup_ms": sum(x["warmup_ms"] for x in stats),
                "capture_ms": sum(x["capture_ms"] for x in stats),
                "pool_mb": sum(x["pool_bytes"] for x in stats) / 2**20, **extra, "card": card})
    log(rec)
    return rec


def launch_record(K):
    """The hand kernels' launch counts so far, and (`<name>_from_replays`)
    how many of them came from CUDA graph replays."""
    return {**K.launch_counts, **{f"{k}_from_replays": n for k, n in K.replay_counts.items()}}


HAND = ("fast9", "lk_track", "lk_level", "uwb_update", "slam_init", "msckf_update")


def counted(K, graphed, fn, rows):
    """fn(), appending to `rows` its hand-kernel launches as (all, from
    graph replays, made by the first call of a key), each a tuple over
    `HAND`: a key's first call runs its body eagerly
    once (the capture's warm-up), which launches what its new graph
    records; every other launch must come from a replay (`replays_gate`)."""
    l0, r0 = dict(K.launch_counts), dict(K.replay_counts)
    e0 = [len(g.entries) for g in graphed]
    out = fn()
    new = [e for g, n in zip(graphed, e0) for e in list(g.entries.values())[n:]]
    rows.append((tuple(K.launch_counts[k] - l0[k] for k in HAND), tuple(K.replay_counts[k] - r0[k] for k in HAND),
                 tuple(sum(e.launches.get(k, 0) for e in new) for k in HAND)))
    return out


def replays_gate(rows):
    """True when every launch of `rows` (`counted`) that no key's first call
    made came from a graph replay."""
    return all(tuple(n - r for n, r in zip(total, rep)) == first for total, rep, first in rows)


def uwb_launch_record(rows, range_sets):
    """The UWB kernel's launches over `rows` (`counted`) against the range
    sets the run updated, and whether there is one launch a range set, all
    from replays but those of each key's first call."""
    k = HAND.index("uwb_update")
    launches = sum(total[k] for total, _, _ in rows)
    replayed = sum(rep[k] for _, rep, _ in rows)
    rec = {"uwb_range_sets": range_sets, "uwb_update_launches": launches,
           "uwb_update_from_replays": replayed, "uwb_update_first_calls": launches - replayed}
    return rec, range_sets > 0 and launches == range_sets and replays_gate(rows)


def slam_init_launch_record(rows, init_frames):
    """The SLAM delayed-init kernel's launches over `rows` (`counted`)
    against the frames whose plan had candidates, and whether there is one
    launch such a frame, all from replays but those of each key's first
    call."""
    k = HAND.index("slam_init")
    launches = sum(total[k] for total, _, _ in rows)
    replayed = sum(rep[k] for _, rep, _ in rows)
    rec = {"slam_init_frames": init_frames, "slam_init_launches": launches,
           "slam_init_from_replays": replayed, "slam_init_first_calls": launches - replayed}
    return rec, init_frames > 0 and launches == init_frames and replays_gate(rows)


def msckf_launch_record(rows, frames):
    """The MSCKF update kernel's launches over `rows` (`counted`) against
    the frames the full step ran (it runs the update on every frame, as
    `uvio_tpu`'s does), and whether there is one launch a frame, all from
    replays but those of each key's first call."""
    k = HAND.index("msckf_update")
    launches = sum(total[k] for total, _, _ in rows)
    replayed = sum(rep[k] for _, rep, _ in rows)
    rec = {"msckf_frames": frames, "msckf_update_launches": launches,
           "msckf_update_from_replays": replayed, "msckf_update_first_calls": launches - replayed}
    return rec, launches == frames and replays_gate(rows)


def stage_names(mgr):
    """The graphed stages of a manager (`manager._stage`)."""
    return sorted(n for n in vars(mgr) if n.startswith("_stage_"))


def spy_stages(mgr, shapes):
    """Each stage of `mgr` behind a wrapper that adds the shapes and dtypes
    of its tensor inputs to `shapes[name]` (a set), keeping `.eager` and
    the stage itself as `.graphed`."""
    import torch
    from torch.utils._pytree import tree_leaves

    for name in stage_names(mgr):
        stage = getattr(mgr, name)

        def call(*args, _stage=stage, _name=name, **kwargs):
            shapes.setdefault(_name, set()).add(tuple((tuple(t.shape), t.dtype) for t in tree_leaves((args, kwargs))
                                                      if isinstance(t, torch.Tensor)))
            return _stage(*args, **kwargs)

        call.eager, call.graphed, call.take_timed = stage.eager, stage, stage.take_timed
        setattr(mgr, name, call)


def traced(make):
    """`make()` with the port's tracing on while it builds, so a staged
    manager's `last_timing` stages take the device ms of their graphs'
    replays (`uvio_tpu_torch/tracing.py`)."""
    from uvio_tpu_torch import tracing

    tracing.enable()
    try:
        return make()
    finally:
        tracing.enable(False)


def stage_graphs(mgr, shapes):
    """{stage: [graphs, distinct input shapes met]} of a spied manager
    (`spy_stages`); raises where a stage holds more graphs than it met
    input shapes (a graph per slot value or per other Python value)."""
    out = {n: [getattr(mgr, n).graphed.stats()["graphs"], len(shapes.get(n, ()))] for n in stage_names(mgr)}
    bad = {n: v for n, v in out.items() if v[0] > v[1]}
    if bad:
        raise RuntimeError(f"stages with more graphs than input shapes: {bad}")
    return out


def share_stages(mgr, source, eager=False):
    """`mgr` runs `source`'s graphed stages (the same layout and options,
    so the same graphs), or their eager bodies."""
    for name in stage_names(source):
        stage = getattr(source, name)
        stage = getattr(stage, "graphed", stage)
        setattr(mgr, name, stage.eager if eager else stage)


def _hard_sim():
    """The simulator of the hard rendered-image regression."""
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    return Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=90, seed=9),
                     trajectory=circle_trajectory(duration=19.0, still_time=5.0))


_RENDER_SIM = None  # a render worker's own simulator


def _init_render_worker(root):
    global _RENDER_SIM
    sys.path.insert(0, root)
    import torch

    torch.set_num_threads(1)
    _RENDER_SIM = _hard_sim()


def _render_hard_frame(t):
    return _RENDER_SIM.render_image_hard(t)


def render_hard(workers=8):
    """The scenario of the hard rendered-image regression, made on the
    host before any clock starts: (camera, events, ground truth), events
    being ("imu", (t, w, a)) and ("cam", (t, 752x480 hard frame)) in feeding
    order, ground truth {t: (q_GtoI, p_IinG)}. A frame is a pure function
    of its stamp, so `workers` processes render them side by side."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    sim = _hard_sim()
    events, gt = [], {}
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        events.append(("imu", r))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= r[0]:
            tc = sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam
            sim.cur_cam_t = tc
            events.append(("cam", tc))
            g = sim.get_gt_state(tc)
            gt[tc] = (g["q_GtoI"], g["p_IinG"])
    root = os.path.dirname(os.path.abspath(__file__))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init_render_worker, initargs=(root,)) as pool:
        imgs = pool.map(_render_hard_frame, [ev for kind, ev in events if kind == "cam"], chunksize=4)
        events = [(kind, (ev, next(imgs)) if kind == "cam" else ev) for kind, ev in events]
    return sim.params.cameras[0], events, gt


def hooked_cov_ok(mgr):
    """A list that receives the `cov_ok` tensor of every step `mgr` runs."""
    seen, full = [], mgr._jit_full

    def hook(state, fields):
        out = full(state, fields)
        seen.append(out[1]["cov_ok"])
        return out

    mgr._jit_full = hook
    return seen


def syncs_of(run):
    """(host syncs, their sources) that `run()` makes, by
    `set_sync_debug_mode("warn")`."""
    with SyncCounter() as c:
        run()
        c.on_frame(0, 0.0)
    return c.per_frame[0], c.sources


def tracker_mono_hard(K, card):
    """Raw hard frames -> KLTTracker -> VioManager (static init + ZUPT) ->
    posyaw ATE on the card, with the gates of the reference's regression;
    the same tracker output also feeds a staged twin of the manager
    (`fused_step=False`, otherwise equal) under the same gates. Then the
    tracker alone on 12 of the frames for its host syncs and kernel
    launches per `feed`. Returns (launch counts, camera, frames)."""
    import numpy as np
    import torch

    from uvio_tpu_torch.eval import ate
    from uvio_tpu_torch.frontend.tracker import KLTTracker
    from uvio_tpu_torch.init.static_init import StaticInitOptions
    from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager

    t0 = time.perf_counter()
    cam, events, gt = render_hard()
    frames = [ev for kind, ev in events if kind == "cam"]
    log({"phase": "tracker", "part": "render", "frames": len(frames), "resolution": "752x480",
         "frame": "render_image_hard", "host_seconds": time.perf_counter() - t0})

    def make_tracker():
        return KLTTracker(cam.intrinsics, cam.model, num_features=150, grid=(6, 8), histeq="HISTOGRAM")

    def make_mgr(fused_step):
        return VioManager(VioConfig(
            max_clones=11, max_msckf_in_update=40, sigma_pix=2.0, use_static_init=True, try_zupt=True,
            zupt_max_disparity=0.0, init_options=StaticInitOptions(wait_for_jerk=False),
            cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC,
                                  p_IinC=cam.p_IinC)], fused_step=fused_step))

    mgr, staged = make_mgr(True), traced(lambda: make_mgr(False))
    staged_shapes = {}
    spy_stages(staged, staged_shapes)
    cov_ok = hooked_cov_ok(mgr)
    staged_cov_ok, check = [], staged._check_cov_ok
    staged._check_cov_ok = lambda ok, where: (staged_cov_ok.append(bool(ok)), check(ok, where))
    tracker = make_tracker()
    if tracker.device != torch.device("cuda:0") or {mgr.device, staged.device} != {tracker.device}:
        raise RuntimeError(f"tracker on {tracker.device}, managers on {mgr.device}, {staged.device}")
    est = {"t": [], "q": [], "p": []}
    est_s = {"t": [], "q": [], "p": []}
    n_tracks, feed_ms, mgr_ms, per_feed, feed_rows, outputs = [], [], [], [], [], []
    staged_rows, staged_syncs, staged_sync_src, pos_diff = [], [], set(), 0.0
    K.reset_launch_counts()
    for kind, ev in events:
        if kind == "imu":
            mgr.feed_imu(*ev)
            staged.feed_imu(*ev)
            continue
        tc, img = ev
        before = dict(K.launch_counts)
        t0 = time.perf_counter()
        # returns after its one read-back
        ids, uvs = counted(K, [tracker.step_first, tracker.step_track], lambda: tracker.feed(tc, img), feed_rows)
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        per_feed.append(tuple(K.launch_counts[k] - before[k] for k in ("fast9", "lk_track", "lk_level")))
        n_tracks.append(len(ids))
        outputs.append((ids, uvs))
        mgr.feed_features(tc, [(ids, uvs)])
        if 150 <= len(n_tracks) < 155:  # a few frames in motion: the staged path's syncs
            n, src = syncs_of(lambda: staged.feed_features(tc, [(ids, uvs)]))
            staged_syncs.append(n)
            staged_sync_src.update(src)
        else:
            staged.feed_features(tc, [(ids, uvs)])
        for m, e in ((mgr, est), (staged, est_s)):
            if m.is_initialized:
                q, p = m.get_pose()
                e["t"].append(tc), e["q"].append(q), e["p"].append(p)
        if mgr.is_initialized and mgr.last_timing:
            mgr_ms.append(mgr.last_timing["total"] * 1e3)
        if staged.is_initialized and staged.last_timing and staged.last_timing["timestamp"] == tc:
            staged_rows.append(dict(staged.last_timing))
        if mgr.is_initialized and staged.is_initialized:
            pos_diff = max(pos_diff, float(np.abs(est["p"][-1] - est_s["p"][-1]).max()))
    launches = launch_record(K)

    def posyaw(e):
        t = np.asarray(e["t"])
        return ate(t, np.asarray(e["q"], np.float64), np.asarray(e["p"], np.float64), t,
                   np.asarray([gt[x][0] for x in e["t"]]), np.asarray([gt[x][1] for x in e["t"]]),
                   method="posyaw")

    res, res_s = posyaw(est), posyaw(est_s)
    cov_ok_all = all(bool(x.item()) for x in cov_ok)
    one_and_one = per_feed[0] == (1, 0, 0) and all(x == (1, 1, 0) for x in per_feed[1:])

    # the tracker alone: host syncs (5 feeds) and kernel launches (5 feeds)
    alone = make_tracker()
    for tc, img in frames[100:102]:
        alone.feed(tc, img)
    with SyncCounter() as syncs:
        for k, (tc, img) in enumerate(frames[102:107]):
            alone.feed(tc, img)
            syncs.on_frame(k, tc)
    n_launch = kernel_launches(lambda: [alone.feed(tc, img) for tc, img in frames[107:112]])[0]
    # the compiled step: the hand kernels each `feed` runs on the device,
    # by the profiler's kernel names; launches a `feed` graphed and eager;
    # ms a `feed` of fresh trackers over 20 frames, eager and graphed in turns
    graphed_prof = launch_profile(lambda: [alone.feed(tc, img) for tc, img in frames[112:117]], steps=5)

    def eager_tracker():
        tr = make_tracker()
        tr.step_first, tr.step_track = tr.step_first.eager, tr.step_track.eager
        return tr

    eager_alone = eager_tracker()
    for tc, img in frames[100:102]:
        eager_alone.feed(tc, img)
    eager_prof = launch_profile(lambda: [eager_alone.feed(tc, img) for tc, img in frames[102:107]], steps=5)

    def ms_a_feed(eager):
        tr = eager_tracker() if eager else make_tracker()
        for tc, img in frames[120:122]:  # the first frame, and the first tracking one (captures)
            tr.feed(tc, img)
        t0 = time.perf_counter()
        for tc, img in frames[122:142]:
            tr.feed(tc, img)
        return (time.perf_counter() - t0) / 20 * 1e3

    timing = abba(lambda: ms_a_feed(True), lambda: ms_a_feed(False))
    by_name = graphed_prof["hand_kernels"]
    rec = {"phase": "tracker", "part": "mono, hard frames -> KLTTracker -> VioManager (static init + ZUPT)",
           "frames": len(frames), "initialized_frames": res["n"], "min_tracks_after_frame_3":
           min(n_tracks[3:]), "ate_posyaw_rmse_pos_m": res["rmse_pos"], "ate_posyaw_rmse_ori_deg":
           res["rmse_ori_deg"], "cov_ok_all": cov_ok_all, "steps": len(cov_ok),
           "tracker_feed_ms_median": statistics.median(feed_ms[3:]),
           "tracker_feed_ms_mean": statistics.fmean(feed_ms[3:]), "tracker_feed_ms_max": max(feed_ms[3:]),
           "manager_frame_ms_median": statistics.median(mgr_ms), "manager_frame_ms_mean":
           statistics.fmean(mgr_ms), "manager_dtype": mgr.cfg.dtype,
           "fast9_lk_track_lk_level_launches_per_feed": sorted(set(per_feed[1:])),
           "first_feed_launches": per_feed[0], "launches": launches,
           "every_launch_after_a_keys_first_call_from_a_replay": replays_gate(feed_rows),
           "host_syncs_per_feed": syncs.per_frame, "sync_sources": syncs.sources,
           "kernel_launches_per_feed": n_launch / 5, "hand_kernels_per_feed_by_profiler": by_name,
           "kernel_launches_consumed_by": ["VioManager (fused)", "VioManager (staged)"], "card": card}
    log(rec)
    compiled_step_line("tracker", "KLTTracker feed (a), 752x480 hard frames", card,
                       [tracker.step_first, tracker.step_track], timing,
                       {"eager": eager_prof, "graphed": graphed_prof})
    compiled_step_line("tracker", "VioManager (fused) of the hard run, float64", card, [mgr.full_step],
                       manager_frame_ms_median=statistics.median(mgr_ms))
    keys = ("uwb", "propagation", "msckf", "slam", "marginalization", "total")
    rec_s = {"phase": "tracker", "part": "mono, hard frames -> the same KLTTracker output -> staged VioManager "
             "(fused_step=False, static init + ZUPT)", "initialized_frames": res_s["n"],
             "ate_posyaw_rmse_pos_m": res_s["rmse_pos"], "ate_posyaw_rmse_ori_deg": res_s["rmse_ori_deg"],
             "fused_ate_posyaw_rmse_pos_m": res["rmse_pos"], "fused_ate_posyaw_rmse_ori_deg": res["rmse_ori_deg"],
             "cov_ok_all_stages": all(staged_cov_ok), "cov_checks": len(staged_cov_ok),
             "staged_frames_timed": len(staged_rows),
             "stage_ms_mean": {k: statistics.fmean(r[k] for r in staged_rows) * 1e3 for k in keys},
             "fused_frame_ms_mean": statistics.fmean(mgr_ms),
             "host_syncs_per_staged_frame": staged_syncs, "staged_sync_sources": sorted(staged_sync_src),
             "max_position_diff_staged_vs_fused_m": pos_diff,
             "stage_graphs_and_input_shapes": stage_graphs(staged, staged_shapes), "card": card}
    log(rec_s)
    if not (res["n"] >= 100 and min(n_tracks[3:]) >= 15 and res["rmse_pos"] < 0.15
            and res["rmse_ori_deg"] < 2.5 and cov_ok_all and len(cov_ok) >= 100 and one_and_one
            and syncs.per_frame == [1] * 5 and replays_gate(feed_rows)
            and by_name == {"fast9_kernel": 1, "lk_kernel": 1, "lk_level_kernel": 0}):
        raise RuntimeError("the hard mono tracker run failed its gates")
    if not (res_s["n"] >= 100 and res_s["rmse_pos"] < 0.15 and res_s["rmse_ori_deg"] < 2.5
            and all(staged_cov_ok) and len(staged_cov_ok) >= 100):
        raise RuntimeError("the staged manager on the hard frames failed its gates")

    # the compiled step of the staged twin: frames 150-169 (in motion) of
    # fresh staged managers fed the same tracker output, eager and graphed
    # in turns, each from the first frame on the gated twin's graphs
    # (bitwise its eager stages) and swapped to the eager bodies at frame
    # 150 in an eager turn; ms a frame by the host clock around
    # `feed_features` (ZUPT attempt and stages) to a synchronize; frame 170
    # profiled once each way
    prof = {}

    def staged_ms(eager):
        m = make_mgr(False)
        share_stages(m, staged)
        n, ms = 0, []
        for kind, ev in events:
            if kind == "imu":
                m.feed_imu(*ev)
                continue
            if n == 150 and eager:
                share_stages(m, staged, eager=True)
            if n == 170:
                if eager not in prof:
                    prof[eager] = launch_profile(lambda: m.feed_features(ev[0], [outputs[n]]))
                break
            t0 = time.perf_counter()
            m.feed_features(ev[0], [outputs[n]])
            torch.cuda.synchronize()
            if n >= 150:
                ms.append((time.perf_counter() - t0) * 1e3)
            n += 1
        return statistics.fmean(ms)

    timing = abba(lambda: staged_ms(True), lambda: staged_ms(False))
    compiled_step_line("tracker", "staged VioManager of the hard run (a), float64, frames 150-169", card,
                       [getattr(staged, n).graphed for n in stage_names(staged)], timing,
                       {"eager": prof[True], "graphed": prof[False]})
    return launches, cam, frames


def tracker_stereo(K, card):
    """A rendered stereo rig (baseline 0.11 m, seed 3) through
    StereoKLTTracker into a two-camera VioManager initialised from ground
    truth, 30 frames. Returns the launch counts."""
    import numpy as np

    from uvio_tpu_torch.frontend.stereo import StereoKLTTracker
    from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager
    from uvio_tpu_torch.sim import SimCamera, SimParams, Simulator, circle_trajectory

    cams = [SimCamera(), SimCamera(p_IinC=np.array([-0.11, 0.0, 0.0]))]
    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3, cameras=cams),
                    trajectory=circle_trajectory(duration=10.0))
    events = []
    n = 0
    while n < 30:
        r = sim.get_next_imu()
        events.append(("imu", r))
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= r[0]:
            tc = sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam
            sim.cur_cam_t = tc
            events.append(("cam", (tc, sim.render_image(tc, cam_idx=0), sim.render_image(tc, cam_idx=1))))
            n += 1
    mgr = VioManager(VioConfig(
        max_clones=11, max_msckf_in_update=40, sigma_pix=2.0,
        cameras=[CameraConfig(model=c.model, intrinsics=c.intrinsics, q_ItoC=c.q_ItoC, p_IinC=c.p_IinC)
                 for c in cams]))
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"])
    cov_ok = hooked_cov_ok(mgr)
    def make_tracker(eager=False):
        tr = StereoKLTTracker(cams[0].intrinsics, cams[1].intrinsics, cams[0].model, num_features=120, grid=(6, 8))
        if eager:
            for name in ("step_first", "step_track", "step_stereo"):
                setattr(tr.left, name, getattr(tr.left, name).eager)
        return tr

    tracker = make_tracker()
    steps = [tracker.left.step_first, tracker.left.step_track, tracker.left.step_stereo]
    matches, disparity, per_feed, feed_ms, feed_rows = [], [], [], [], []
    K.reset_launch_counts()
    for kind, ev in events:
        if kind == "imu":
            mgr.feed_imu(*ev)
            continue
        tc, left, right = ev
        before = dict(K.launch_counts)
        t0 = time.perf_counter()
        (ids_l, uv_l), (ids_r, uv_r) = obs = counted(K, steps, lambda: tracker.feed(tc, left, right), feed_rows)
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        per_feed.append(tuple(K.launch_counts[k] - before[k] for k in ("fast9", "lk_track", "lk_level")))
        mgr.feed_features(tc, obs)
        if len(per_feed) > 1:
            at = dict(zip(ids_l, uv_l))
            matches.append(len(ids_r))
            disparity.append(float(np.median([abs(uv_r[j][0] - at[ids_r[j]][0]) for j in range(len(ids_r))])))
    launches = launch_record(K)
    p_err = float(np.linalg.norm(mgr.get_pose()[1] - sim.get_gt_state(tc)["p_IinG"]))
    cov_ok_all = all(bool(x.item()) for x in cov_ok)
    frames = [ev for kind, ev in events if kind == "cam"]

    # the compiled step: the hand kernels each `feed` runs on the device, by
    # the profiler's kernel names (5 feeds after the first two); ms a `feed`
    # of fresh trackers over 12 frames, eager and graphed in turns
    def fed(eager, first, last):
        tr = make_tracker(eager)
        for tc, left, right in frames[:first]:
            tr.feed(tc, left, right)
        return tr, lambda: [tr.feed(tc, left, right) for tc, left, right in frames[first:last]]

    prof = {eager: launch_profile(fed(eager, 2, 7)[1], steps=5) for eager in (True, False)}
    by_name = prof[False]["hand_kernels"]

    def ms_a_feed(eager):
        _, run = fed(eager, 2, 14)
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) / 12 * 1e3

    rec = {"phase": "tracker", "part": "stereo, StereoKLTTracker -> two-camera VioManager",
           "frames": len(per_feed), "min_stereo_matches": min(matches), "median_abs_disparity_px_range":
           [min(disparity), max(disparity)], "cov_ok_all": cov_ok_all, "steps": len(cov_ok),
           "final_p_err_m": p_err, "tracker_feed_ms_median": statistics.median(feed_ms[3:]),
           "fast9_lk_track_lk_level_launches_per_feed": sorted(set(per_feed[1:])),
           "first_feed_launches": per_feed[0], "launches": launches,
           "every_launch_after_a_keys_first_call_from_a_replay": replays_gate(feed_rows),
           "hand_kernels_per_feed_by_profiler": by_name,
           "stereo_match_graphs": tracker.left.step_stereo.stats()["graphs"], "card": card}
    log(rec)
    if not (min(matches) >= 10 and 2.0 < min(disparity) and max(disparity) < 20.0 and cov_ok_all
            and len(cov_ok) == 30 and p_err < 0.5 and per_feed[0] == (1, 1, 0)
            and all(x == (1, 2, 0) for x in per_feed[1:]) and replays_gate(feed_rows)
            and by_name == {"fast9_kernel": 1, "lk_kernel": 2, "lk_level_kernel": 0}):
        raise RuntimeError("the stereo tracker run failed its gates")
    compiled_step_line("tracker", "StereoKLTTracker feed (b)", card, steps,
                       abba(lambda: ms_a_feed(True), lambda: ms_a_feed(False)),
                       {"eager": prof[True], "graphed": prof[False]})
    return launches


def tracker_descriptor(K, card):
    """8 rendered frames (seed 3) through DescriptorTracker under the gates;
    then the compiled step over 12 more. Returns the launch counts."""
    from uvio_tpu_torch.frontend.descriptor import DescriptorTracker
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3),
                    trajectory=circle_trajectory(duration=10.0))
    cam = sim.params.cameras[0]
    frames = []
    for _ in range(14):
        tc, _ = sim.get_next_cam()
        frames.append((tc, sim.render_image(tc)))

    def make_tracker(eager=False):
        tr = DescriptorTracker(cam.intrinsics, cam.model, grid=(6, 8))
        if eager:
            tr.step_first, tr.step_match = tr.step_first.eager, tr.step_match.eager
        return tr

    tracker = make_tracker()
    steps = [tracker.step_first, tracker.step_match]
    lengths, n_tracks, per_feed, feed_ms, feed_rows = {}, [], [], [], []
    K.reset_launch_counts()
    for tc, img in frames[:8]:
        before = dict(K.launch_counts)
        t0 = time.perf_counter()
        ids, _ = counted(K, steps, lambda: tracker.feed(tc, img), feed_rows)
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        per_feed.append(tuple(K.launch_counts[k] - before[k] for k in ("fast9", "lk_track", "lk_level")))
        n_tracks.append(len(ids))
        for fid in ids:
            lengths[fid] = lengths.get(fid, 0) + 1
    launches = launch_record(K)

    # the compiled step, as for the stereo tracker (b)
    def fed(eager, first, last):
        tr = make_tracker(eager)
        for tc, img in frames[:first]:
            tr.feed(tc, img)
        return lambda: [tr.feed(tc, img) for tc, img in frames[first:last]]

    prof = {eager: launch_profile(fed(eager, 2, 7), steps=5) for eager in (True, False)}
    by_name = prof[False]["hand_kernels"]

    def ms_a_feed(eager):
        run = fed(eager, 2, 14)
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) / 12 * 1e3

    rec = {"phase": "tracker", "part": "descriptor, DescriptorTracker", "frames": 8,
           "min_tracks": min(n_tracks), "longest_track": max(lengths.values()),
           "tracker_feed_ms_median": statistics.median(feed_ms[3:]),
           "fast9_lk_track_lk_level_launches_per_feed": sorted(set(per_feed)), "launches": launches,
           "every_launch_after_a_keys_first_call_from_a_replay": replays_gate(feed_rows),
           "hand_kernels_per_feed_by_profiler": by_name, "card": card}
    log(rec)
    if not (min(n_tracks) >= 15 and max(lengths.values()) >= 6 and all(x == (1, 0, 0) for x in per_feed)
            and replays_gate(feed_rows) and by_name == {"fast9_kernel": 1, "lk_kernel": 0, "lk_level_kernel": 0}):
        raise RuntimeError("the descriptor tracker run failed its gates")
    compiled_step_line("tracker", "DescriptorTracker feed (c)", card, steps,
                       abba(lambda: ms_a_feed(True), lambda: ms_a_feed(False)),
                       {"eager": prof[True], "graphed": prof[False]})
    return launches


def tracker_kernels_vs_plain(K, cam, frames, card):
    """One `feed`'s device work at 752x480 through the kernels and through
    their plain versions, from the same forced tracker state and with the
    same RANSAC noise."""
    import torch

    from uvio_tpu_torch.frontend import tracker as T
    from uvio_tpu_torch.frontend.klt import gumbel_noise

    tr = T.KLTTracker(cam.intrinsics, cam.model, num_features=150, grid=(6, 8), histeq="HISTOGRAM")
    for tc, img in frames[120:123]:
        tr.feed(tc, img)
    _, img = frames[123]
    noise = gumbel_noise((64, 8, tr.cap), torch.Generator(device=tr.device).manual_seed(5), tr.device)

    def device_work():
        img_d, pyr = tr._preprocess(img)
        uv, active = tr._table()
        score = T.fast_score(img_d, tr.fast_thresh)
        uv_new, ok, tracked = tr._track(pyr, uv, active, noise)
        det_uv, det_ok = tr._detect(img_d, uv_new, tracked)
        return score, uv_new, ok, tracked, det_uv, det_ok, active

    K.reset_launch_counts()
    with_kernels = device_work()
    counts = dict(K.launch_counts)
    kernel_fns = T.fast_score, T.lk_track
    T.fast_score, T.lk_track = K.fast_score_ref, K.lk_track_ref
    plain = device_work()
    T.fast_score, T.lk_track = kernel_fns
    if dict(K.launch_counts) != counts or counts != {"fast9": 2, "lk_track": 1, "lk_level": 0, "uwb_update": 0,
                                                     "slam_init": 0, "msckf_update": 0}:
        raise RuntimeError(f"launch counts {counts} then {dict(K.launch_counts)}")
    (s_k, uv_k, ok_k, tr_k, du_k, dk_k, active), (s_p, uv_p, ok_p, tr_p, du_p, dk_p, _) = with_kernels, plain
    both = ok_k & ok_p & active
    rec = {"phase": "tracker", "part": "kernels against plain versions inside one feed",
           "fast9_max_abs_err": (s_k - s_p).abs().max().item(), "corners": int((s_k > 0).sum().item()),
           "active": int(active.sum().item()), "lk_ok": int((ok_k & active).sum().item()),
           "lk_ok_differs": int((ok_k != ok_p).sum().item()),
           "lk_max_abs_err_px": (uv_k[both] - uv_p[both]).abs().max().item(),
           "tracked_differs": int((tr_k != tr_p).sum().item()),
           "detections_differ": int((dk_k != dk_p).sum().item() + (du_k[dk_k & dk_p] != du_p[dk_k & dk_p]).sum().item()),
           "card": card}
    log(rec)
    if not (rec["fast9_max_abs_err"] == 0.0 and rec["lk_ok_differs"] == 0 and rec["lk_ok"] >= 50
            and rec["lk_max_abs_err_px"] <= 3.4e-4 and rec["detections_differ"] == 0):
        raise RuntimeError("the kernels disagree with their plain versions inside the tracker")


def tracker_clahe(K, card):
    """(e) `KLTTracker(histeq="CLAHE")` on 12 rendered 752x480 frames
    (seed 3) under the gates of tests/test_torch_tracker.py:187; its first
    frame's detections equal a CPU tracker's on the same frame. Returns
    the launch counts."""
    import numpy as np
    import torch

    from uvio_tpu_torch.frontend.klt import gumbel_noise
    from uvio_tpu_torch.frontend.tracker import KLTTracker
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(sim_freq_cam=10.0, num_pts=60, seed=3), trajectory=circle_trajectory(duration=12.0))
    cam = sim.params.cameras[0]
    frames = []
    for _ in range(12):
        tc, _ = sim.get_next_cam()
        frames.append((tc, sim.render_image(tc)))
    make = lambda device: KLTTracker(cam.intrinsics, cam.model, num_features=150, grid=(6, 8), histeq="CLAHE",
                                     device=device)
    tracker = make("cuda:0")
    noise = gumbel_noise((64, 8, tracker.cap), torch.Generator().manual_seed(5), "cpu")
    lengths, prev, drifts, n_tracks, per_feed, feed_ms, feed_rows = {}, {}, [], [], [], [], []
    K.reset_launch_counts()
    for i, (tc, img) in enumerate(frames):
        before = dict(K.launch_counts)
        t0 = time.perf_counter()
        ids, uvs = counted(K, [tracker.step_first, tracker.step_track],
                           lambda: tracker.feed(tc, img, gumbel=noise.to(tracker.device) if i == 0 else None),
                           feed_rows)
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        per_feed.append(tuple(K.launch_counts[k] - before[k] for k in ("fast9", "lk_track", "lk_level")))
        if i == 0:
            first = [(ids, uvs), make("cpu").feed(tc, img, gumbel=noise)]  # the CPU runs the plain versions
        n_tracks.append(len(ids))
        for fid, uv in zip(ids, uvs):
            lengths[fid] = lengths.get(fid, 0) + 1
            if fid in prev:
                drifts.append(float(np.linalg.norm(uv - prev[fid])))
            prev[fid] = uv
    launches = launch_record(K)
    same_first = all(np.array_equal(a, b) for a, b in zip(*first))
    rec = {"phase": "tracker", "part": "CLAHE, KLTTracker(histeq=\"CLAHE\")", "frames": len(frames),
           "min_tracks": min(n_tracks), "longest_track": max(lengths.values()),
           "median_drift_px": statistics.median(drifts), "first_frame_equals_cpu": same_first,
           "first_frame_detections": len(first[0][0]), "tracker_feed_ms_median": statistics.median(feed_ms[3:]),
           "fast9_lk_track_lk_level_launches_per_feed": sorted(set(per_feed[1:])),
           "first_feed_launches": per_feed[0], "launches": launches,
           "every_launch_after_a_keys_first_call_from_a_replay": replays_gate(feed_rows), "card": card}
    log(rec)
    if not (min(n_tracks) >= 20 and max(lengths.values()) >= 8 and statistics.median(drifts) < 30.0
            and same_first and per_feed[0] == (1, 0, 0) and all(x == (1, 1, 0) for x in per_feed[1:])
            and replays_gate(feed_rows)):
        raise RuntimeError("the CLAHE tracker run failed its gates")
    return launches


def tracker_aruco(card):
    """(e) `ArucoTracker` (host cv2) on the scene of tests/test_torch_aruco.py:22,
    under that test's gates."""
    import cv2
    import numpy as np

    from uvio_tpu_torch.frontend.aruco import ARUCO_ID_BASE, ArucoTracker

    def render_tag(tag_id=7, size=120, pos=(60, 40), img_hw=(240, 320)):
        d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_6X6_250)
        img = np.full(img_hw, 180, np.uint8)
        img[pos[0]:pos[0] + size, pos[1]:pos[1] + size] = cv2.aruco.generateImageMarker(d, tag_id, size)
        return img

    tr = ArucoTracker()
    ids, uvs = tr.feed(0.0, render_tag())
    ids2, _ = tr.feed(0.1, render_tag(pos=(70, 50)))
    ids3, uv3 = tr.feed(0.2, np.full((240, 320), 128, np.uint8))
    rec = {"phase": "tracker", "part": "ArUco, ArucoTracker", "cv2": cv2.__version__,
           "ids": sorted(int(i) for i in ids), "u_range": [float(uvs[:, 0].min()), float(uvs[:, 0].max())],
           "v_range": [float(uvs[:, 1].min()), float(uvs[:, 1].max())], "ids_second_frame_same": set(ids2) == set(ids),
           "ids_empty_frame": len(ids3), "card": card}
    log(rec)
    if not (len(ids) == 4 and set(ids) == {ARUCO_ID_BASE + 4 * 7 + c for c in range(4)}
            and uvs[:, 0].min() >= 35 and uvs[:, 0].max() <= 165 and uvs[:, 1].min() >= 55
            and uvs[:, 1].max() <= 185 and set(ids2) == set(ids) and len(ids3) == 0 and uv3.shape == (0, 2)):
        raise RuntimeError("the ArUco tracker failed its gates")


def tracker_phase(K, card):
    """The image trackers on the card (module docstring, phase 10):
    {path: launch counts}."""
    mono, cam, frames = tracker_mono_hard(K, card)
    by_path = {"tracker_mono": mono, "tracker_stereo": tracker_stereo(K, card),
               "tracker_descriptor": tracker_descriptor(K, card), "tracker_clahe": tracker_clahe(K, card)}
    tracker_kernels_vs_plain(K, cam, frames, card)
    tracker_aruco(card)
    return by_path


def kernels_phase(lib, K, dev, imgs, card):
    """Phases 3-6 of the module docstring: the yardsticks, both clocks and
    every kernel against its plain version. Returns {kernel: record}."""
    import torch

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

    for rec in kernels.values():
        rec["profiler_ms"] = None  # the slice phase reads it where it runs
    return kernels


def slice_phase(K, dev, render_out, card):
    """Phase 7 of the module docstring. Returns (launch counts, the hand
    kernels' device ms by name under the profiler)."""
    import warnings

    import numpy as np
    import torch

    sim, imgs, stamps, imu = render_out
    # ---- the slice ---------------------------------------------------
    steps, step, make_carry, st0, frames, windows = slice_steps(dev, sim, imgs, stamps, imu)

    def run_slice(eager=False):
        infos = []
        for st, info in steps(eager):
            infos.append(info)
        torch.cuda.synchronize()
        return st, infos

    K.reset_launch_counts()
    st, infos = run_slice()
    launches = launch_record(K)
    n_steps = len(windows)
    if dict(K.launch_counts) != {"fast9": n_steps, "lk_track": n_steps, "lk_level": 0, "uwb_update": 0, "slam_init": 0,
                                 "msckf_update": n_steps}:
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

    # nothing inside a step waits for the host; count what does
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gen = torch.Generator(device=dev).manual_seed(0)
        carry = make_carry(frames[0])
        torch.cuda.synchronize()
        step(st0, carry, frames[1], *windows[0][:3], windows[0][3], generator=gen)
    torch.cuda.set_sync_debug_mode(0)
    sync_ops = sorted({str(w.message).split("\n")[0][:120] for w in caught})

    def ms_per_frame(eager):
        t0 = time.perf_counter()
        run_slice(eager)
        return (time.perf_counter() - t0) / n_steps * 1e3

    timing = abba(lambda: ms_per_frame(True), lambda: ms_per_frame(False))
    reps = timing["graphed_ms"]
    # the same kernels' device time by name under the profiler, 5 steps
    def five_steps():
        frames_it = steps()
        for _ in range(5):
            next(frames_it)

    profiled = profiled_kernel_ms(five_steps)
    by_name = launch_profile(five_steps, steps=5)["hand_kernels"]
    slice_rec.update({"per_frame_ms_median": statistics.median(reps), "per_frame_ms_reps": reps,
                      "host_syncs_in_one_step": len(caught), "sync_sources": sync_ops,
                      "profiled_kernels": profiled, "hand_kernels_per_step_by_profiler": by_name, "card": card})
    log(slice_rec)
    if caught:
        raise RuntimeError(f"{len(caught)} host syncs inside one slice step: {sync_ops}")
    if by_name != {"fast9_kernel": 1, "lk_kernel": 1, "lk_level_kernel": 0}:
        raise RuntimeError(f"the profiler saw {by_name} hand kernels a slice step")
    gen = torch.Generator(device=dev).manual_seed(0)
    carry = make_carry(frames[0])
    one = lambda fn: lambda: fn(st0, carry, frames[1], *windows[0][:3], windows[0][3], generator=gen)
    compiled_step_line("slice", "fused image->pose step", card, [step.graphed], timing,
                       {"eager": launch_profile(one(step.eager)), "graphed": launch_profile(one(step))})
    return launches, profiled



ROOT = os.path.dirname(os.path.abspath(__file__))


# ceilings on one `solve_dynamic_init` attempt on the card: warm, at 10 or
# 50 Gauss-Newton steps, and in the run, where the first attempt also pays
# the process's first use of the solver's kernels and libraries; a stall
# longer than that while a run starts is a regression
WARM_SOLVE_MS_CEILING = 6000.0
SOLVE_MS_CEILING = 30000.0


def init_in_motion(card):
    """The end-to-end scenario of tests/test_dynamic_init.py through
    `VioManager` on the card, every solver attempt timed to its read-back
    (module docstring, phase 11 (a))."""
    import dataclasses

    import numpy as np
    import torch

    import uvio_tpu_torch.manager as TM
    from uvio_tpu_torch.eval import ate
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(seed=11), trajectory=circle_trajectory(duration=24.0, lap_s=8.0))
    cam = sim.params.cameras[0]
    mgr = TM.VioManager(TM.VioConfig(
        max_clones=11, sigma_pix=1.0, use_static_init=True, use_dynamic_init=True, max_slam=15,
        cameras=[TM.CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC,
                                 p_IinC=cam.p_IinC)]))
    if mgr.device != torch.device("cuda:0"):
        raise RuntimeError(f"the manager runs on {mgr.device}")
    cov_ok = hooked_cov_ok(mgr)
    attempts, last_args, solve = [], [], TM.solve_dynamic_init

    def timed(*args):
        t0 = time.perf_counter()
        out = solve(*args)
        rmse = float(out["rmse_norm"])  # the read-back
        attempts.append({"ms": (time.perf_counter() - t0) * 1e3, "rmse_norm": rmse,
                         "rcond": float(out["rcond"]), "steps_taken": int(out["accepted"].sum().item()),
                         "device": str(out["rcond"].device)})
        last_args[:] = args
        return out

    TM.solve_dynamic_init = timed
    est, init_t, tc = {"t": [], "q": [], "p": [], "gq": [], "gp": []}, None, 0.0
    t0 = time.perf_counter()
    try:
        while sim.ok():
            r = sim.get_next_imu()
            if r is None:
                break
            mgr.feed_imu(*r)
            if sim.cur_cam_t + 0.1 <= r[0]:
                rc = sim.get_next_cam()
                if rc is None:
                    break
                tc, obs = rc
                mgr.feed_features(tc, obs)
                if mgr.is_initialized:
                    init_t = tc if init_t is None else init_t
                    q, p = mgr.get_pose()
                    g = sim.get_gt_state(tc)
                    for k, v in (("t", tc), ("q", q), ("p", p), ("gq", g["q_GtoI"]), ("gp", g["p_IinG"])):
                        est[k].append(v)
            if init_t is not None and tc - init_t > 12:
                break
    finally:
        TM.solve_dynamic_init = solve
    wall = time.perf_counter() - t0
    if init_t is None:
        log({"phase": "init", "part": "dynamic init in motion", "attempts": attempts})
        raise RuntimeError("dynamic initialization never fired")
    t = np.asarray(est["t"])
    res = ate(t, np.asarray(est["q"]), np.asarray(est["p"]), t, np.asarray(est["gq"]),
              np.asarray(est["gp"]), method="posyaw")
    launches, graph_launches, device_kernels = kernel_launches(lambda: solve(*last_args)["rcond"].item())

    def warm_ms(opts):
        t1 = time.perf_counter()
        float(solve(*last_args[:-1], opts)["rmse_norm"])  # the read-back
        return (time.perf_counter() - t1) * 1e3

    # the last window again, warm, at its own and at the vendored configs'
    # 50 Gauss-Newton steps
    warm = {n: warm_ms(dataclasses.replace(last_args[-1], gn_iters=n)) for n in (last_args[-1].gn_iters, 50)}
    cov_ok_all = all(bool(x.item()) for x in cov_ok)
    rec = {"phase": "init", "part": "dynamic init in motion (seed 11, VioManager, float64)",
           "init_after_start_s": init_t - sim.t_start, "attempts": len(attempts),
           "gn_iters": last_args[-1].gn_iters, "solve_ms_per_attempt": [a["ms"] for a in attempts],
           "attempt_results": attempts, "warm_solve_ms_by_gn_iters": warm,
           "kernel_launches_per_solve": launches, "graph_launches_per_solve": graph_launches,
           "device_kernels_per_solve": device_kernels, "frames_after_init": len(t),
           "ate_posyaw_rmse_pos_m": res["rmse_pos"], "ate_posyaw_rmse_ori_deg": res["rmse_ori_deg"],
           "cov_ok_all": cov_ok_all, "steps": len(cov_ok), "wall_s": wall, "card": card}
    log(rec)
    if not (init_t - sim.t_start < 5.0 and res["rmse_pos"] < 0.25 and cov_ok_all and len(cov_ok) > 100
            and all(a["device"] == "cuda:0" for a in attempts)):
        raise RuntimeError("dynamic initialization in motion failed its gates")
    if max(warm.values()) > WARM_SOLVE_MS_CEILING or max(a["ms"] for a in attempts) > SOLVE_MS_CEILING:
        raise RuntimeError(f"a solver attempt took more than {WARM_SOLVE_MS_CEILING} ms warm "
                           f"or {SOLVE_MS_CEILING} ms in the run")


def init_run_euroc(K, card):
    """`run_euroc` on a synthetic ASL dataset (module docstring, phase 11
    (b)). Returns the launch counts."""
    from uvio_tpu_torch.eval import ate
    from uvio_tpu_torch.frontend import tracker as T
    from uvio_tpu_torch.native import get_lib
    from uvio_tpu_torch.utils.euroc import EurocDataset, run_euroc, write_synthetic_dataset

    per_feed, feed_ms, devices, feed = [], [], set(), T.KLTTracker.feed

    def counted(self, *args, **kw):
        before = dict(K.launch_counts)
        t0 = time.perf_counter()
        out = feed(self, *args, **kw)
        feed_ms.append((time.perf_counter() - t0) * 1e3)
        per_feed.append(tuple(K.launch_counts[k] - before[k] for k in ("fast9", "lk_track", "lk_level")))
        devices.add(str(self.device))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root, cfg = write_synthetic_dataset(tmp, os.path.join(ROOT, "data", "streams", "mono", "config"))
        write_s = time.perf_counter() - t0
        T.KLTTracker.feed = counted
        K.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            t, q, p = run_euroc(root, cfg, out_path=os.path.join(tmp, "est.txt"))
        finally:
            T.KLTTracker.feed = feed
        run_s = time.perf_counter() - t0
        launches = launch_record(K)
        gt = EurocDataset(root).groundtruth()
    res = ate(t, q, p, gt["t"], gt["q_GtoI"], gt["p"], method="posyaw")
    native = get_lib() is not None
    rec = {"phase": "init", "part": "run_euroc on a synthetic ASL dataset (seed 13, 16 s, 5 s at rest)",
           "frames": len(per_feed), "poses": len(t), "ate_posyaw_rmse_pos_m": res["rmse_pos"],
           "ate_posyaw_rmse_ori_deg": res["rmse_ori_deg"],
           "fast9_lk_track_lk_level_launches_per_feed": sorted(set(per_feed[1:])),
           "first_feed_launches": per_feed[0] if per_feed else None, "launches": launches,
           "tracker_devices": sorted(devices), "native_library_built": native,
           "tracker_feed_ms_median": statistics.median(feed_ms[3:]), "write_dataset_s": write_s,
           "run_s": run_s, "card": card}
    log(rec)
    if not (len(t) >= 25 and res["rmse_pos"] < 0.5 and per_feed[0] == (1, 0, 0) and native
            and all(x == (1, 1, 0) for x in per_feed[1:]) and devices == {"cuda:0"}):
        raise RuntimeError("run_euroc failed its gates")
    return launches


def init_phase(K, card):
    """The in-motion initializer and the dataset entry point (module
    docstring, phase 11): {path: launch counts}."""
    init_in_motion(card)
    return {"run_euroc": init_run_euroc(K, card)}


def stream_replay(stream, card):
    """A vendored stream through the port's config loader and manager on
    the card (module docstring, phase 12): its record, or an error when it
    misses its gates."""
    import dataclasses

    import torch

    from uvio_tpu_torch.eval import ate, load_tum
    from uvio_tpu_torch.manager import VioManager
    from uvio_tpu_torch.utils import load_config
    from uvio_tpu_torch.utils.streams import anchor_errors, replay
    from uvio_tpu_torch.uwb_manager import UVioManager

    data = os.path.join(ROOT, "data", "streams", stream)
    cfg, _ = load_config(os.path.join(data, "config"))
    manager = UVioManager if stream == "uwb" else VioManager
    mgr = manager(dataclasses.replace(cfg, use_static_init=False, use_dynamic_init=False))
    if mgr.device != torch.device("cuda:0"):
        raise RuntimeError(f"the manager runs on {mgr.device}")
    cov_ok = hooked_cov_ok(mgr)
    frame_ms = []
    t0 = time.perf_counter()
    t, q, p = replay(mgr, data, on_frame=lambda m: frame_ms.append(m.last_timing["total"] * 1e3))
    wall = time.perf_counter() - t0
    tg, qg, pg = load_tum(os.path.join(data, "gt.txt"))
    ours = ate(t, q, p, tg, qg, pg, method="se3")
    ref = ate(*load_tum(os.path.join(data, "ref_est.txt")), tg, qg, pg, method="se3")
    cov_ok_all = all(bool(x.item()) for x in cov_ok)
    rec = {"phase": "streams", "stream": f"data/streams/{stream}", "manager": manager.__name__, "dtype": cfg.dtype,
           "cameras": len(cfg.cameras), "max_slam": cfg.max_slam, "frames": len(t),
           "ate_se3_rmse_pos_m": ours["rmse_pos"], "ate_se3_rmse_pos_m_cpp_reference": ref["rmse_pos"],
           "ate_se3_rmse_ori_deg": ours["rmse_ori_deg"], "ate_se3_rmse_ori_deg_cpp_reference": ref["rmse_ori_deg"],
           "cov_ok_all": cov_ok_all, "steps": len(cov_ok), "frame_ms_median": statistics.median(frame_ms[20:]),
           "frame_ms_mean": statistics.fmean(frame_ms[20:]), "wall_s": wall, "card": card}
    ok = len(t) > 400 and ours["rmse_pos"] <= ref["rmse_pos"] and cov_ok_all and len(cov_ok) == len(t)
    if stream == "uwb":
        anchors, anchors_ref = anchor_errors(mgr, data)
        rec.update(anchor_rmse_m=anchors, anchor_rmse_m_cpp_reference=anchors_ref)
        ok = ok and anchors <= anchors_ref
    else:  # tests/test_vendored_streams.py's orientation gate
        ok = ok and ours["rmse_ori_deg"] <= 1.2 * ref["rmse_ori_deg"]
    if not ok:
        raise RuntimeError(f"the vendored {stream} stream failed the C++ reference's gates: {rec}")
    return rec


STREAMS = ("stereo", "uwb", "mono")  # longest first, ahead of the scenarios


def _init_pool_worker(root):
    os.environ["OMP_NUM_THREADS"] = "1"  # before numpy and torch load: one host thread a worker
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _pool_job(kind, name, card):
    t0 = time.perf_counter()
    if kind == "stream":
        rec = stream_replay(name, card)
    else:
        import torch_e2e_scenarios

        rec = {"phase": "estimator", **torch_e2e_scenarios.run(name, "cuda:0"), "card": card}
    return {**rec, "job_seconds": time.perf_counter() - t0}


def pool_phase(jobs, card):
    """The `estimator` scenarios and the vendored streams (module
    docstring, phases 12 and 15), side by side in spawned worker processes,
    each with its own CUDA context and one host thread. Every record is
    printed; any failed job fails the run once all have ended."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed

    cores = len(os.sched_getaffinity(0))
    workers = max(1, min(6, len(jobs), cores - 2))
    log({"phase": "pool", "workers": workers, "host_cores": cores, "jobs": [f"{k}:{n}" for k, n in jobs]})
    failed, t0 = [], time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init_pool_worker, initargs=(ROOT,)) as pool:
        futures = {pool.submit(_pool_job, kind, name, card): (kind, name) for kind, name in jobs}
        for f in as_completed(futures):
            kind, name = futures[f]
            try:
                log(f.result())
            except Exception as e:  # reported with every other job's result, then fails the run below
                failed.append(f"{kind}:{name}")
                log({"phase": "estimator" if kind == "scenario" else "streams", "case": name, "failed": repr(e)[:4000]})
    log({"phase": "pool", "seconds": time.perf_counter() - t0, "workers": workers, "failed": failed})
    if failed:
        raise RuntimeError(f"failed: {failed}")


def estimator_compiled_step(card, name="uwb"):
    """The compiled step of the estimator scenarios: scenario `name` in
    this process, its managers' fused step graphed and eager in turns
    (the eager one by `make_packed_full_step(cfg).eager`), under the
    scenario's gates each time."""
    import torch_e2e_scenarios as scenarios

    from uvio_tpu_torch import manager as M

    graphed_step, recs = M.make_packed_full_step, []

    def run(eager):
        M.make_packed_full_step = (lambda cfg: graphed_step(cfg).eager) if eager else graphed_step
        try:
            recs.append(scenarios.run(name, "cuda:0"))
        finally:
            M.make_packed_full_step = graphed_step
        return recs[-1]["ms_per_frame"]

    timing = abba(lambda: run(True), lambda: run(False))
    g = recs[1]
    log({"phase": "estimator", "part": f"scenario {name}, the managers' ms a frame (median)", "layer": "compiled step",
         "eager_ms_per_frame": timing["eager_ms"], "graphed_ms_per_frame": timing["graphed_ms"],
         "eager_ms_median": statistics.median(timing["eager_ms"]),
         "graphed_ms_median": statistics.median(timing["graphed_ms"]), "graphs": g["graphs"],
         "warmup_and_capture_ms": g["graph_capture_ms"], "pool_mb": g["graph_pool_mb"],
         "ate_pos_m": [r["ate_pos_m"] for r in recs], "card": card})


def backend_map(card):
    """The live map backend on the card (module docstring, phase 13 (b)):
    the scenario of tests/test_map_backend.py:45 through a staged float64
    `VioManager` into `MapBackend`, then `refine()`, under that test's
    gates."""
    import numpy as np
    import torch

    from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager
    from uvio_tpu_torch.math import quat_to_rot
    from uvio_tpu_torch.parallel import MapBackend, MapBackendOptions
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    sim = Simulator(SimParams(sim_freq_imu=200.0, sim_freq_cam=10.0, num_pts=50, seed=11),
                    trajectory=circle_trajectory(duration=16.0))
    cam = sim.params.cameras[0]
    mgr = VioManager(VioConfig(
        max_clones=11, max_msckf_in_update=40, sigma_pix=sim.params.sigma_pix, fused_step=False,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC, p_IinC=cam.p_IinC)]))
    backend = MapBackend(MapBackendOptions(every_n_frames=3, max_keyframes=48, lm_bucket=64))
    if mgr.device != torch.device("cuda:0") or backend.device != mgr.device:
        raise RuntimeError(f"manager on {mgr.device}, backend on {backend.device}")
    g0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, g0["q_GtoI"], g0["p_IinG"], g0["v_IinG"], g0["bg"], g0["ba"])
    R_ItoC = quat_to_rot(torch.as_tensor(cam.q_ItoC)).numpy()
    gt_cam_p, frames, ingest_ms, frame_ms = {}, 0, [], []
    t0 = time.perf_counter()
    while sim.ok():
        r = sim.get_next_imu()
        if r is None:
            break
        mgr.feed_imu(*r)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= r[0]:
            rc = sim.get_next_cam()
            if rc is None:
                break
            mgr.feed_features(*rc)
            frames += 1
            frame_ms.append(mgr.last_timing["total"] * 1e3)
            t1 = time.perf_counter()
            if backend.ingest(mgr):
                ingest_ms.append((time.perf_counter() - t1) * 1e3)
                g = sim.get_gt_state(rc[0])
                R_GtoI = quat_to_rot(torch.as_tensor(g["q_GtoI"])).numpy()
                gt_cam_p[rc[0]] = g["p_IinG"] - R_GtoI.T @ (R_ItoC.T @ cam.p_IinC)
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = backend.refine()  # returns after its read-backs
    refine_ms = (time.perf_counter() - t0) * 1e3
    costs = res["costs"]
    kf_err = np.linalg.norm(res["kf_p"] - np.asarray([gt_cam_p[t] for t in res["kf_t"]]), axis=1)
    errs = np.asarray([np.linalg.norm(p - sim.map_pts[fid]) for fid, p in res["points"].items()])
    rec = {"phase": "backend", "part": "staged VioManager (float64) -> MapBackend -> refine, "
           "the scenario of tests/test_map_backend.py:45", "frames": frames,
           "keyframes": backend.num_keyframes, "points": len(errs), "cost_first": float(costs[0]),
           "cost_last": float(costs[-1]), "kf_err_median_m": float(np.median(kf_err)),
           "landmark_err_median_m": float(np.median(errs)), "refine_ms_first_call": refine_ms,
           "ingest_ms_median": statistics.median(ingest_ms), "staged_frame_ms_mean": statistics.fmean(frame_ms),
           "run_s": run_s, "card": card}
    log(rec)
    if not (backend.num_keyframes >= 20 and costs[-1] <= costs[0] and np.median(kf_err) < 0.05
            and len(errs) >= 20 and np.median(errs) < 0.05):
        raise RuntimeError("the map backend failed its gates")


def ba_scene(N, L, seed=3):
    """`tests/test_ba.py`'s scene at any size: N keyframes on an arc looking
    at L landmarks in a 3 m cube, 0.5 px noise at f = 450, then perturbed
    (0.02 rad, 5 cm, 10 cm; the first keyframe exact). Returns (q0, p0,
    lm0, obs, mask) as numpy."""
    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from uvio_tpu_torch.math import rot_to_quat

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 1.2, N)
    p = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * th], axis=1)
    lm = rng.uniform(-1.5, 1.5, (L, 3))
    z = -p / np.linalg.norm(p, axis=1, keepdims=True)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    R = np.stack([x, np.cross(z, x), z], axis=1)  # R_GtoC
    pc = np.einsum("nij,lnj->lni", R, lm[:, None] - p[None])
    obs = pc[..., :2] / pc[..., 2:3] + (0.5 / 450.0) * rng.standard_normal((L, N, 2))
    mask = (pc[..., 2] > 0.5) & (np.abs(obs) < 0.9).all(-1)
    dR = Rotation.from_rotvec(0.02 * rng.standard_normal((N, 3))).as_matrix()
    dR[0] = np.eye(3)
    q0 = rot_to_quat(torch.as_tensor(dR @ R)).numpy()
    p0 = p + np.concatenate([np.zeros((1, 3)), 0.05 * rng.standard_normal((N - 1, 3))])
    return q0, p0, lm + 0.1 * rng.standard_normal(lm.shape), obs, mask


def backend_ba(card):
    """BA at the backend's full capacity (module docstring, phase 13 (c)):
    N = 64 keyframes, L = 4096 landmarks, 10 iterations, float64, on the
    card against the card machine's CPU; ms per solve, launches and host
    syncs."""
    import numpy as np
    import torch

    from uvio_tpu_torch.parallel.ba import BAOptions, ba_solve

    N, L, iters = 64, 4096, 10
    scene = ba_scene(N, L)
    on = lambda dev: [torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else torch.float64, device=dev)
                      for a in scene]
    args_d, opts = on("cuda:0"), BAOptions(iters=iters)
    solve = lambda: ba_solve(*args_d, opts)
    ba_solve(*args_d, BAOptions(iters=1))[3]["costs"].cpu()  # first use of the solver libraries
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = solve()
        out[3]["costs"].cpu()  # the one read-back
        ms.append((time.perf_counter() - t0) * 1e3)
    n_syncs, sources = syncs_of(solve)
    launches, graphs, _ = kernel_launches(solve)
    t0 = time.perf_counter()
    ref = ba_solve(*on("cpu"), opts)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    costs, costs_ref = out[3]["costs"].cpu().numpy(), ref[3]["costs"].numpy()
    cost_rel = float(np.abs(costs / costs_ref - 1.0).max())
    param_diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(out[:3], ref[:3]))
    # float64 Jacobians Jp (L,N,2,6) and Jl, blocks Hpl (L,N,6,3), B and B A^-1 (L,6N,3)
    work_bytes = 8 * (L * N * 12 + L * N * 6 + L * N * 18 + 2 * L * 6 * N * 3)
    rec = {"phase": "backend", "part": f"ba_solve N={N} L={L} iters={iters} float64, card vs CPU",
           "observations": int(scene[4].sum()), "cost_first": float(costs[0]), "cost_last": float(costs[-1]),
           "cost_rel_diff_max": cost_rel, "param_abs_diff_max": param_diff,
           "ms_per_solve_median": statistics.median(ms), "ms_per_solve": ms, "cpu_ms_per_solve": cpu_ms,
           "kernel_launches_per_solve": launches, "graph_launches_per_solve": graphs,
           "host_syncs_in_solve": n_syncs, "sync_sources": sources,
           "jacobian_schur_gb": work_bytes / 1e9, "card": card}
    log(rec)
    if not (cost_rel <= 1e-9 and param_diff <= 1e-8 and n_syncs == 0 and costs[-1] < costs[0]):
        raise RuntimeError("BA on the card failed its gates")


def backend_staged_fixture(card):
    """`bench.py`'s scenario through the staged `UVioManager` on the card
    against `uvio_tpu`'s staged run (module docstring, phase 13 (d))."""
    import numpy as np
    import torch

    from uvio_tpu_torch.eval.capture import bench_scenario, drive
    from uvio_tpu_torch.fixtures import (STAGED_FRAMES, STAGED_WARM, load_staged_fixture, staged_differences,
                                         staged_record)

    ref = load_staged_fixture()
    sim, mgr = traced(lambda: bench_scenario(STAGED_WARM + 100, seed=7, max_slam=25, dtype="float64",
                                             fused_step=False))
    if mgr.device != torch.device("cuda:0"):
        raise RuntimeError(f"the manager runs on {mgr.device}")
    shapes = {}
    spy_stages(mgr, shapes)
    drive(sim, mgr, STAGED_WARM)
    recs, before, rows, syncs, sources = [], [mgr.__dict__.get("last_msckf_info")], [], [], set()

    def on_frame(k, tc):
        recs.append(staged_record(mgr, tc, lambda x: x.cpu().numpy(), before[0]))
        before[0] = mgr.__dict__.get("last_msckf_info")
        rows.append(dict(mgr.last_timing))

    t0 = time.perf_counter()
    drive(sim, mgr, STAGED_FRAMES - 5, on_frame=on_frame)
    for _ in range(5):  # the last frames one by one, their host syncs counted
        n, src = syncs_of(lambda: drive(sim, mgr, 1, on_frame=on_frame))
        syncs.append(n)
        sources.update(src)
    run_s = time.perf_counter() - t0
    got = {k: np.stack([r[k] for r in recs]) for k in recs[0]}
    d = staged_differences(got, ref)
    keys = ("uwb", "propagation", "msckf", "slam", "marginalization", "total")
    rec = {"phase": "backend", "part": "bench.py's scenario, staged UVioManager (float64) vs uvio_tpu's staged "
           "run (fixtures/staged_seed7.npz)", "frames": len(got["t"]), "position_diff_max_m": d["p_m"],
           "quaternion_diff_max": d["q"], "cov_trace_rel_diff_max": d["cov_trace_rel"],
           "decisions_differ": d["decisions"], "msckf_updates": int(got["msckf_ran"].sum()),
           "uwb_ranges_accepted_last_set": int(got["uwb_accepted"].sum()),
           "slam_slots_full_at_end": int((got["slam_fid"][-1] >= 0).sum()),
           "stage_ms_mean": {k: statistics.fmean(r[k] for r in rows) * 1e3 for k in keys},
           "host_syncs_per_frame": syncs, "sync_sources": sorted(sources), "run_s": run_s,
           "stage_graphs_and_input_shapes": stage_graphs(mgr, shapes), "card": card}
    log(rec)
    if not (len(got["t"]) == len(ref["t"]) and not d["decisions"] and d["p_m"] <= 1e-6
            and d["cov_trace_rel"] <= 1e-6):
        raise RuntimeError("the staged UVioManager differs from uvio_tpu's staged run")

    # the compiled step: fresh staged managers on the gated run's graphs
    # (bitwise its eager stages) through the warm-up frames, then, eager
    # or graphed in turns, 10 timed frames (`last_timing` total: the UWB
    # drain to the frame's last read-back, without the simulator) and 50
    # IMU-rate poses after them (`get_propagated_pose` at each IMU sample,
    # host clock to each pose's read-back); one frame and one pose
    # profiled each way
    prof = {"frame": {}, "pose": {}}

    def turn(eager):
        sim_t, m = bench_scenario(STAGED_WARM + 100, seed=7, max_slam=25, dtype="float64", fused_step=False)
        share_stages(m, mgr)
        drive(sim_t, m, STAGED_WARM)
        share_stages(m, mgr, eager=eager)
        totals = []
        drive(sim_t, m, 10, on_frame=lambda k, tc: totals.append(m.last_timing["total"]))
        frame_ms = 1e3 * statistics.fmean(totals)
        if eager not in prof["frame"]:
            prof["frame"][eager] = launch_profile(lambda: drive(sim_t, m, 1))
        imu = []
        while len(imu) < 51:  # the IMU after the frame, up to before the next one
            imu.append(sim_t.get_next_imu())
        t0 = time.perf_counter()
        for t, w, a in imu[:50]:
            m.feed_imu(t, w, a)
            m.get_propagated_pose(t)
        pose_ms = (time.perf_counter() - t0) / 50 * 1e3
        if eager not in prof["pose"]:
            m.feed_imu(*imu[50])
            prof["pose"][eager] = launch_profile(lambda: m.get_propagated_pose(imu[50][0]))
        return frame_ms, pose_ms

    t, w, a = sim.get_next_imu()  # capture the pose step's graph before any turn
    mgr.feed_imu(t, w, a)
    mgr.get_propagated_pose(t)
    frame_t, pose_t = {"eager_ms": [], "graphed_ms": []}, {"eager_ms": [], "graphed_ms": []}
    for eager in (True, False, False, True):
        key = "eager_ms" if eager else "graphed_ms"
        frame_ms, pose_ms = turn(eager)
        frame_t[key].append(frame_ms)
        pose_t[key].append(pose_ms)
    stages = [getattr(mgr, n).graphed for n in stage_names(mgr) if n != "_stage_fast_prop"]
    compiled_step_line("backend", "staged UVioManager (d), bench.py's scenario, float64, 10 frames a turn", card,
                       stages, frame_t, {"eager": prof["frame"][True], "graphed": prof["frame"][False]},
                       graphs_by_stage={n: getattr(mgr, n).graphed.stats()["graphs"] for n in stage_names(mgr)})
    compiled_step_line("backend", "get_propagated_pose (IMU-rate pose) of the staged UVioManager (d), 50 IMU "
                       "samples a turn", card, [mgr._stage_fast_prop.graphed], pose_t,
                       {"eager": prof["pose"][True], "graphed": prof["pose"][False]})


def backend_phase(card):
    """Bundle adjustment, the map backend and the staged managers on the
    card (module docstring, phase 13)."""
    backend_map(card)
    backend_ba(card)
    backend_staged_fixture(card)


def batch_inputs(dev, dtype, B=None):
    """The batched fixture, the batched step, and its inputs tiled to B
    (all four sequences by default) on `dev` in `dtype`: (fx, step,
    state0, [(bundle, plan)] a frame)."""
    from uvio_tpu_torch.fixtures import load_batched_fixture, stage_batched_fixture
    from uvio_tpu_torch.pipeline import FullStepConfig, make_batched_full_step

    fx = load_batched_fixture()
    state0, staged = stage_batched_fixture(fx, B, device=dev, dtype=dtype)
    return fx, make_batched_full_step(FullStepConfig.from_dict(fx.config)), state0, staged


def batch_fixture(dev, card):
    """(a), (b): the fixture's four sequences as one batch, float64 against
    JAX's vmapped float64 replay, float32 against its float32 gates."""
    import numpy as np
    import torch

    fx, step, st, staged = batch_inputs(dev, torch.float64)
    ref, bad, p_err, tr_err = fx.replays["f64"], [], 0.0, 0.0
    t0 = time.perf_counter()
    for k, (fb, plan) in enumerate(staged):
        st, info = step(st, fb, plan)
        got = {key: info[key] for key in ("cov_ok", "zupt_accepted", "slam_kept", "slam_failed",
                                          "slam_inited", "uwb_accepted")}
        got.update({"msckf_" + key: info["msckf"][key] for key in ("tri_ok", "kept", "num_used", "cov_ok")})
        bad += [{"frame": k, "info": key, "got": v.cpu().tolist(), "jax": ref[key][k].tolist()}
                for key, v in got.items() if not np.array_equal(v.cpu().numpy(), ref[key][k])]
        p_err = max(p_err, float(np.abs(st.p.cpu().numpy() - ref["p"][k]).max()))
        tr = torch.diagonal(st.cov, dim1=-2, dim2=-1).sum(-1).cpu().numpy()
        tr_err = max(tr_err, float(np.abs(tr / ref["cov_trace"][k] - 1.0).max()))
    B, n = len(fx.seeds), len(staged)
    rec = {"phase": "batch", "part": "fixture_float64", "seeds": fx.seeds.tolist(), "warm": fx.warm.tolist(),
           "frames": n, "plans_differ": {name: sum(bool((getattr(p, name) != getattr(p, name)[:1]).any().item())
                                                   for _, p in staged) for name in ("uwb_rows", "slam_init", "marg")},
           "infos_equal_all": not bad, "max_p_diff_m": p_err, "max_trace_rel_diff": tr_err,
           "ms_per_step_with_readback": (time.perf_counter() - t0) / n * 1e3, "card": card}
    log(rec)
    if bad or not (p_err <= 1e-6 and tr_err <= 1e-6):
        for b in bad[:20]:
            log(b)
        raise RuntimeError("the batched float64 step disagrees with JAX's vmapped replay")

    fx, step, st, staged = batch_inputs(dev, torch.float32)
    cov_ok = []
    for fb, plan in staged:
        st, info = step(st, fb, plan)
        cov_ok.append(info["cov_ok"])
    cov_ok = torch.stack(cov_ok).cpu().numpy()
    final = np.linalg.norm(st.p.cpu().numpy().astype(np.float64) - fx.replays["f32"]["p"][-1], axis=1)
    rec = {"phase": "batch", "part": "fixture_float32", "frames": n, "sequences": B,
           "cov_ok_all": bool(cov_ok.all()), "final_p_diff_vs_jax_m": final.tolist(), "card": card}
    log(rec)
    if not (cov_ok.all() and (final <= 0.02).all()):
        raise RuntimeError("the batched float32 step failed its gates")


def batch_sweep(dev, card, batches=(1, 8, 32), timed=20):
    """(c): ms, sequence-frames/s, launches, host syncs and peak memory of
    the batched float32 step at each B, after a warm pass over the timed
    frames (it captures every graph they need); the operations vmap loops
    over."""
    import warnings

    import torch

    from uvio_tpu_torch.fixtures import load_batched_fixture
    from uvio_tpu_torch.pipeline import FullStepConfig, bundle_from_numpy, make_full_step, plan_frame
    from uvio_tpu_torch.types.state import state_from_numpy

    # the single step on sequence 0's frames, the same clock, for B = 1
    fx = load_batched_fixture()
    single = make_full_step(FullStepConfig.from_dict(fx.config))
    s0 = state_from_numpy({k: v[0] for k, v in fx.state0.items()}, dev, torch.float32)
    frames, t = [], float(fx.state0["time"][0])
    for frame in fx.bundles[:timed]:
        frames.append((bundle_from_numpy(frame[0], dev, torch.float32), plan_frame(frame[0], t)))
        t = float(frame[0]["stamp_time"])

    def run_single(n, fn=single):
        st = s0
        for fb, plan in frames[:n]:
            st, _ = fn(st, fb, plan)

    def ms_per_step(run, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    run_single(timed)
    single_ms = ms_per_step(run_single, timed)
    log({"phase": "batch", "part": "sweep", "B": "single step", "ms_per_step": single_ms,
         "launches_per_step": kernel_launches(lambda: single(s0, *frames[1]))[0], "card": card})
    eager_frames = 10  # the eager step in turns with the graphed one
    compiled_step_line("batch", "single full step, float32, sequence 0 of the batched fixture", card, [single],
                       abba(lambda: ms_per_step(lambda n: run_single(n, single.eager), eager_frames),
                            lambda: ms_per_step(run_single, eager_frames)),
                       {"eager": launch_profile(lambda: single.eager(s0, *frames[1])),
                        "graphed": launch_profile(lambda: single(s0, *frames[1]))})

    fallbacks, rows = set(), []
    for B in batches:
        fx, step, state0, staged = batch_inputs(dev, torch.float32, B)

        def run(frames, fn=step):
            st = state0
            for fb, plan in frames:
                st, _ = fn(st, fb, plan)
            return st

        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run(staged[:timed])
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
        fallbacks |= {str(w.message).split(" for ")[-1].split(".")[0] for w in caught
                      if "batching rule" in str(w.message)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(staged[:timed])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        fb, plan = staged[1]
        syncs, sources = syncs_of(lambda: step(state0, fb, plan))
        launches, graphs, kernels = kernel_launches(lambda: step(state0, fb, plan))
        rows.append({"B": B, "ms_per_step": wall / timed * 1e3, "seq_frames_per_s": B * timed / wall,
                     "launches_per_step": launches, "device_kernels_per_step": kernels,
                     "host_syncs_per_step": syncs, "sync_sources": sources, "peak_memory_bytes": peak})
        log({"phase": "batch", "part": "sweep", **rows[-1], "card": card})
        compiled_step_line("batch", f"batched full step, float32, B={B}", card, [step],
                           abba(lambda: ms_per_step(lambda n: run(staged[:n], step.eager), eager_frames),
                                lambda: ms_per_step(lambda n: run(staged[:n]), eager_frames)),
                           {"eager": launch_profile(lambda: step.eager(state0, fb, plan)),
                            "graphed": launch_profile(lambda: step(state0, fb, plan))},
                           B=B, distinct_union_plans=len({p.union for _, p in staged[:timed]}))
    log({"phase": "batch", "part": "vmap_fallbacks", "ops": sorted(fallbacks), "card": card})
    if any(r["host_syncs_per_step"] for r in rows):
        raise RuntimeError("a batched step waits for the host")
    return rows


def batch_twins(card):
    """(d): the two example twins on the card at reduced repetitions, run
    side by side (their times here are not measurements: each shares the
    card and the host with the other)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = {"profile_step_torch": ["--iters", "3", "--chunk", "5", "--chunk-iters", "1"],
            "scaling_torch": ["--batches", "1,4", "--frames", "3", "--reps", "1", "--ba-reps", "1"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", name + ".py"), *args],
                                    cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, args in runs.items()}
    try:
        outs = {name: p.communicate(timeout=400) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (out, err) in outs.items():
        rc, lines = procs[name].returncode, out.strip().splitlines()
        log({"phase": "batch", "part": "twin", "script": name, "args": runs[name], "rc": rc,
             "seconds_both": time.perf_counter() - t0, "card": card})
        if rc != 0 or not lines:
            print(err[-4000:], file=sys.stderr)
            raise RuntimeError(f"examples/{name}.py failed with exit code {rc}")
        print(lines[-1], flush=True)


def batch_phase(dev, card):
    """The batched full step on the card (module docstring, phase 14)."""
    batch_fixture(dev, card)
    batch_sweep(dev, card)
    batch_twins(card)


PHASES = ("kernels", "slice", "full_step", "manager", "tracker", "init", "streams", "backend", "batch", "estimator")


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ", ".join(PHASES) + " (default: all)")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
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
         "cuda": torch.version.cuda, "device_count": torch.cuda.device_count(),
         "phases": [p for p in PHASES if p in phases]})

    # ---- build -------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    lib = _build.load()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "lib": _build.LIB_PATH})
    print(report, file=sys.stderr)

    render_out = render(60) if phases & {"kernels", "slice"} else None
    if render_out is not None:
        log({"phase": "render", "frames": len(render_out[1]), "resolution": "752x480"})
    seconds, t0 = {}, time.perf_counter()

    def done(phase):
        nonlocal t0
        seconds[phase] = time.perf_counter() - t0
        t0 = time.perf_counter()

    kernels = None
    if "kernels" in phases:
        kernels = kernels_phase(lib, K, dev, render_out[1], card)
        done("kernels")
    by_path = {}
    if "slice" in phases:
        by_path["slice"], profiled = slice_phase(K, dev, render_out, card)
        if kernels is not None:
            kernels["fast9"]["profiler_ms"] = profiled.get("fast9_kernel", {}).get("ms")
            kernels["lk_track"]["profiler_ms"] = profiled.get("lk_kernel", {}).get("ms")
        done("slice")
    if "full_step" in phases:
        full_step_phase(dev, card)
        done("full_step")
    if "manager" in phases:
        manager_phase(dev, card)
        done("manager")
    if "tracker" in phases:
        by_path.update(tracker_phase(K, card))
        done("tracker")
    if "init" in phases:
        by_path.update(init_phase(K, card))
        done("init")
    if phases & {"streams", "estimator"}:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import torch_e2e_scenarios as scenarios

        pool_phase([("stream", n) for n in STREAMS if "streams" in phases]
                   + [("scenario", n) for n in scenarios.SCENARIOS if "estimator" in phases], card)
        if "estimator" in phases:
            estimator_compiled_step(card)
        done("+".join(p for p in ("streams", "estimator") if p in phases))
    if "backend" in phases:
        backend_phase(card)
        done("backend")
    if "batch" in phases:
        batch_phase(dev, card)
        done("batch")

    log({"phase": "total", "seconds": time.perf_counter() - t_start, "phase_seconds": seconds})
    if kernels is not None:
        total = {k: sum(p[k] for p in by_path.values()) for k in kernels}
        for k in kernels:
            kernels[k]["launches_by_path"] = {path: p[k] for path, p in by_path.items()}
            kernels[k]["replay_launches_by_path"] = {path: p[f"{k}_from_replays"] for path, p in by_path.items()}
        src = "uvio_tpu_torch/csrc/"
        log({"kernels": [
            {"name": "fast9", "route": "cuda", "source": src + "fast9.cu",
             "replaces": "uvio_tpu/frontend/pallas_kernels.py:78", "launches": total["fast9"],
             **kernels["fast9"]},
            {"name": "lk_level", "route": "cuda", "source": src + "lk_level.cu",
             "replaces": "uvio_tpu/frontend/pallas_kernels.py:617", "launches": total["lk_level"],
             **kernels["lk_level"]},
            {"name": "lk_track", "route": "cuda", "source": src + "lk_level.cu",
             "replaces": "uvio_tpu/frontend/pallas_kernels.py:617", "launches": total["lk_track"],
             **kernels["lk_track"]},
        ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

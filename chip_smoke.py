#!/usr/bin/env python3
"""Build the port's CUDA kernels and run its raw-image -> pose step and
its UWB + SLAM filter step on one NVIDIA GPU: the quickest proof that
`uvio_tpu_torch` works on the card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. card   — `nvidia-smi` name and power limit; full-float32 matmuls set;
  2. build  — nvcc builds csrc/*.cu (sm_90a) from the checkout;
  3. fast9  — kernel vs plain PyTorch on a rendered 752x480 frame and a
              random one (max abs diff <= 1e-4), both timed;
  4. lk     — kernel vs plain on the 4 pyramid levels of two rendered
              frames, 150 features, both iteration settings (ok masks
              differ in at most 1 of 150, <= 1e-3 px where both keep a
              track), both timed;
  5. slice  — the simulator renders 60 frames (752x480, seed 9, 200 Hz
              IMU, 10 Hz camera); the fused step runs each on cuda:0 with
              a float32 state; gates of tests/test_fused_vio.py; 1 fast9
              and 4 lk_level launches per step; median per-frame time over
              3 warm repetitions.
  6. full_step — `pipeline.full_filter_step` replays the 100 frames of the
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
Then the kernel table, the `nvidia-smi` line, and the result line.
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
    from uvio_tpu_torch.frontend.klt import build_pyramid, hist_equalize

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
    _build.load()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "lib": _build.LIB_PATH})
    print(report, file=sys.stderr)

    sim, imgs, stamps, imu = render(60)
    log({"phase": "render", "frames": len(imgs), "resolution": "752x480"})
    kernels = {}

    # ---- fast9 vs plain ------------------------------------------------
    rendered = hist_equalize(torch.as_tensor(imgs[0], device=dev))
    rnd = torch.rand((480, 752), generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev) * 255.0
    err = 0.0
    for img in (rendered, rnd):
        a = K.fast_score(img, 20.0)
        b = K.fast_score_ref(img, 20.0)
        torch.cuda.synchronize()
        err = max(err, (a - b).abs().max().item())
        if (a > 0).sum().item() == 0:
            raise RuntimeError("fast9 found no corners")
    if not err <= 1e-4:
        raise RuntimeError(f"fast9 disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: K.fast_score(rendered, 20.0), 200)
    plain_ms = cuda_ms(lambda: K.fast_score_ref(rendered, 20.0), 20)
    kernels["fast9"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log({"phase": "fast9", "shape": [480, 752], "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "card": card})

    # ---- lk_level vs plain ---------------------------------------------
    pyr0 = build_pyramid(rendered, 4)
    pyr1 = build_pyramid(hist_equalize(torch.as_tensor(imgs[1], device=dev)), 4)
    rng = np.random.default_rng(0)
    uv0 = torch.as_tensor(rng.uniform([24, 24], [752 - 24, 480 - 24], (150, 2)),
                          dtype=torch.float32, device=dev)
    valid = torch.ones(150, dtype=torch.bool, device=dev)
    lk_err, lk_ms, lk_plain_ms = 0.0, 0.0, 0.0
    for lev in range(4):
        uv_l = (uv0 / 2.0**lev).contiguous()
        for iters, min_eig in ((10, 25.0), (6, 0.0)):
            args = (pyr0[lev], pyr1[lev], uv_l, uv_l, valid, 7, iters, min_eig)
            uv_k, ok_k = K.lk_level(*args)
            uv_r, ok_r = K.lk_level_ref(*args)
            torch.cuda.synchronize()
            diff = torch.nonzero(ok_k != ok_r).flatten().tolist()
            both = ok_k & ok_r
            e = (uv_k[both] - uv_r[both]).abs().max().item() if both.any().item() else 0.0
            rec = {"phase": "lk_level", "level": lev, "shape": list(pyr0[lev].shape),
                   "iters": iters, "min_eig": min_eig, "ok": int(ok_k.sum().item()),
                   "ok_plain": int(ok_r.sum().item()), "ok_differs": diff, "max_abs_err": e}
            if diff:
                rec["differing"] = [{"i": i, "uv": uv_l[i].tolist(), "kernel": uv_k[i].tolist(),
                                     "plain": uv_r[i].tolist()} for i in diff]
            if len(diff) > 1 or not e <= 1e-3:
                log(rec)
                raise RuntimeError("lk_level disagrees with its plain version")
            lk_err = max(lk_err, e)
            # the main path's settings: 10 iterations on level 0, 6 above
            if (iters == 10) == (lev == 0):
                rec["ms"] = cuda_ms(lambda: K.lk_level(*args), 200)
                rec["plain_ms"] = cuda_ms(lambda: K.lk_level_ref(*args), 10)
                lk_ms += rec["ms"]
                lk_plain_ms += rec["plain_ms"]
            log(rec)
    kernels["lk_level"] = dict(max_abs_err=lk_err, ms=lk_ms, plain_ms=lk_plain_ms)
    log({"phase": "lk_level", "per_frame_4_levels_ms": lk_ms, "plain_ms": lk_plain_ms,
         "card": card})

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
    if launches != {"fast9": n_steps, "lk_level": 4 * n_steps}:
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
    slice_rec.update({"per_frame_ms_median": statistics.median(reps), "per_frame_ms_reps": reps,
                      "host_syncs_in_one_step": len(caught), "sync_sources": sync_ops,
                      "card": card})
    log(slice_rec)

    full_step_phase(dev, card)

    log({"kernels": [
        {"name": "fast9", "route": "cuda", "source": "uvio_tpu_torch/csrc/fast9.cu",
         "replaces": "uvio_tpu/frontend/pallas_kernels.py:78", "launches": launches["fast9"],
         **kernels["fast9"]},
        {"name": "lk_level", "route": "cuda", "source": "uvio_tpu_torch/csrc/lk_level.cu",
         "replaces": "uvio_tpu/frontend/pallas_kernels.py:617", "launches": launches["lk_level"],
         **kernels["lk_level"]},
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

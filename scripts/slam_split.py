#!/usr/bin/env python3
"""A filter stage's split on a benchmark cell's own state, each part
graphed alone, by the graph clock: the SLAM stage (`--stage slam`) or the
MSCKF update (`--stage msckf`).

    python3 scripts/slam_split.py [--stage slam|msckf] [--workload euroc_v101.klt_live] [--seed N]
                                  [--frame 40] [--root DIR]

Makes the cell's traffic and drives its estimator as fast as it goes.
The first frame from `--frame` on whose plan has SLAM candidates (with
`--stage msckf`: MSCKF features) is kept as the fused step receives it
(the manager's state and the frame's fields); the step's stages before
the one split then run on it eagerly, and each part is timed by
`chip_smoke.graph_ms` (L2 warm, as on the main path).

`--stage slam`, after the UWB drain, propagate+clone and the MSCKF update:

  * `slam_update_ms`: `slam_update` on that state;
  * `slam_delayed_init_ms`: `slam_delayed_init` on the state
    `slam_update` leaves (the kernel's route and its batched part, where
    the program has the kernel; the plain loop where it has not);
  * where the program has the kernel: `plain_ms`, its plain version
    `slam_delayed_init_ref` on the same state and card.

`--stage msckf`, after the UWB drain and propagate+clone, the parts of
`update/msckf.py` `msckf_update`'s plain body, each on the inputs the part
before it made:

  * `systems_ms`: undistortion, `clone_camera_poses`, `triangulate_batch`,
    `feature_system` and the masking of features that failed;
  * `project_ms`: `_pack_rows` and `nullspace_project`;
  * `gate_ms`: `chi2_gate`;
  * `compress_ms`: the reduced QR of the stacked kept rows and `Q.T @ r`;
  * `ekf_update_ms`: `ekf_update` with the compressed system;
  * `msckf_update_ms`: the whole call as the step runs it (the kernel's
    route where the program has the kernel), and there `plain_ms`, its
    plain version `msckf_update_ref`;

beside each part, the kernels it runs on the card by name and count
(`kernels`, one eager call under `torch.profiler`).

The kernels alone, against their plain versions and their bounds, are
timed by chip_smoke.py's `full_step` phase.

`--root` imports the port from another checkout (e.g. the parent commit
unpacked by `git archive`), with this tree's benchmark and chip_smoke, so
that both are timed on the same inputs and card. Prints one JSON line.
Needs the card.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=("slam", "msckf"), default="slam")
    ap.add_argument("--workload", default="euroc_v101.klt_live")
    ap.add_argument("--seed", type=int, default=2147483647)
    ap.add_argument("--frame", type=int, default=40)
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("slam_split: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    from chip_smoke import graph_ms
    from port_bench import harness

    sys.path.insert(0, root)
    import uvio_tpu_torch
    from uvio_tpu_torch import pipeline
    from uvio_tpu_torch.filter.propagator import propagate_and_clone
    from uvio_tpu_torch.update import slam
    from uvio_tpu_torch.update.msckf import msckf_update

    if not os.path.abspath(uvio_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"uvio_tpu_torch came from {uvio_tpu_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    _, config, mix = harness.cell_files(args.workload)
    drv = harness.cell_driver(config, mix)
    # 40 frames past `--frame` at the cell's camera rate (EuRoC 20 Hz, the corridor 10 Hz)
    warmup_s = (args.frame + 40) / config["sim"]["cam_hz"]
    traffic = drv.make_traffic(config, dict(mix, warmup_s=warmup_s), args.seed, 0.05,
                               harness.BENCH_DIR, frames=1)
    est = drv.Estimator(harness.program_package(drv.MODULES), config, traffic, harness.BENCH_DIR, dev)
    mgr = est.mgr
    kept = []
    full = mgr._jit_full

    wanted = ((lambda f: (np.asarray(f["cand_ids"]) >= 0).any()) if args.stage == "slam" else
              (lambda f: np.asarray(f["msckf_mask"]).any()))

    def keep(state, fields):
        k = len(keep.frames)
        keep.frames.append(k)
        if not kept and k >= args.frame and wanted(fields):
            kept.append((type(state)(**{n: getattr(state, n).clone() for n in vars(state)}),
                         {n: np.array(v, copy=True) for n, v in fields.items()}, mgr._time_host, k))
        return full(state, fields)

    keep.frames = []
    mgr._jit_full = keep
    est.initialize()
    for kind, i in traffic.stream.events:
        harness.feed(est, kind, i)
        if kept:
            break
    if not kept:
        raise RuntimeError(f"no frame from {args.frame} on had what --stage {args.stage} splits")
    state, fields, time_host, frame = kept[0]
    torch.cuda.synchronize()

    cfg = mgr._full_cfg
    L = cfg.layout
    fb = pipeline.bundle_from_numpy(fields, dev, state.cov.dtype)
    st, _, _ = pipeline._uwb_drain(state, fb, pipeline.plan_frame(fields, time_host), cfg)
    st = propagate_and_clone(st, L, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises, cfg.gravity_mag,
                             integration=cfg.integration, stamp_time=fb.stamp_time)
    head = {"card": torch.cuda.get_device_name(0), "root": root, "stage": args.stage, "workload": args.workload,
            "seed": args.seed, "frame": frame, "dim": L.dim, "dtype": str(state.cov.dtype)}
    if args.stage == "msckf":
        print(json.dumps({**head, **msckf_split(st, L, cfg, fb)}), flush=True)
        return 0
    st, _ = msckf_update(st, L, cfg.cam_model, fb.msckf_uv, fb.msckf_mask, sigma_pix=cfg.sigma_pix,
                         chi2_mult=cfg.chi2_mult)
    kw = dict(sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult)
    update = lambda: slam.slam_update(st, L, fb.slam_uv, fb.slam_mask, cfg.cam_model, **kw)
    st_u, uinfo = update()
    init_args = (L, fb.cand_uv, fb.cand_mask, fb.cand_slots, fb.cand_ids, cfg.cam_model)
    init = lambda: slam.slam_delayed_init(st_u, *init_args, **kw)
    _, iinfo = init()
    rec = {**head, "max_slam": L.max_slam, "landmarks_in_state": int(st.slam_valid.sum()),
           "landmarks_with_observations": int(fb.slam_mask.any(-1).any(-1).sum()),
           "candidates": int((fb.cand_ids >= 0).sum()), "inited": int(iinfo["inited"].sum()),
           "slam_update_ms": graph_ms(update, k=10, replays=5),
           "slam_delayed_init_ms": graph_ms(init, k=10, replays=5)}
    if hasattr(slam, "slam_delayed_init_ref"):
        rec["plain_ms"] = graph_ms(lambda: slam.slam_delayed_init_ref(st_u, *init_args, **kw), k=10, replays=5)
    print(json.dumps(rec), flush=True)
    return 0


def kernels_of(fn):
    """{kernel name (its first 90 characters): launches} of one eager
    fn() on the card, from `torch.profiler`'s device records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.name().startswith(("Memcpy", "Memset")):
            names[e.name()[:90]] = names.get(e.name()[:90], 0) + 1
    return dict(sorted(names.items(), key=lambda kv: -kv[1]))


def msckf_split(st, L, cfg, fb):
    """The MSCKF update's parts on `st` (module docstring), each timed on
    what the part before it made."""
    import torch

    from chip_smoke import graph_ms
    from uvio_tpu_torch.cam import models as cam_models
    from uvio_tpu_torch.filter.ekf import ekf_update
    from uvio_tpu_torch.update import msckf

    K, C, dtype = L.max_clones, L.num_cams, st.cov.dtype
    obs_uv, obs_mask, sp = fb.msckf_uv.to(dtype), fb.msckf_mask, cfg.sigma_pix

    def systems():
        uvn = torch.stack([cam_models.undistort(st.calib_cam_intr[c], cfg.cam_model, obs_uv[:, :, c, :])
                           for c in range(C)], dim=2)
        (R_val, p_val), _ = msckf.clone_camera_poses(st, L)
        feat_p, tri_ok = msckf.triangulate_batch(uvn.reshape(-1, K * C, 2), obs_mask.reshape(-1, K * C),
                                                 R_val.reshape(K * C, 3, 3), p_val.reshape(K * C, 3))
        Hx, H_f, res, rm = msckf.feature_system(st, L, cfg.cam_model, feat_p, feat_p, obs_uv, obs_mask, sp)
        ok = tri_ok & (rm.sum(1) >= 4)
        okf = ok.to(dtype)
        return Hx * okf[:, None, None], H_f * okf[:, None, None], res * okf[:, None], rm & ok[:, None], ok

    Hx, H_f, res, rm, ok = systems()

    def project():
        Hx_p, H_f_p, res_p, rm_p = msckf._pack_rows(Hx, H_f, res, rm)
        return (*msckf.nullspace_project(Hx_p, H_f_p, res_p), rm_p)

    Hx_proj, res_proj, rm_p = project()
    gate = lambda: msckf.chi2_gate(Hx_proj, res_proj, st.cov, rm_p.sum(1), sp, cfg.chi2_mult)
    keep = gate()[0] & ok
    F, Mp, D = Hx_proj.shape

    def compress():
        w = keep.to(dtype)
        Q, Rf = torch.linalg.qr((Hx_proj * w[:, None, None]).reshape(F * Mp, D), mode="reduced")
        return Rf, Q.T @ (res_proj * w[:, None]).reshape(F * Mp)

    Rf, r_c = compress()
    r_diag = torch.full((D,), sp**2, dtype=dtype, device=Rf.device)
    rows = torch.ones((D,), dtype=torch.bool, device=Rf.device)
    update = lambda: ekf_update(st, L, Rf, r_c, r_diag, rows)
    whole = lambda: msckf.msckf_update(st, L, cfg.cam_model, fb.msckf_uv, fb.msckf_mask, sigma_pix=sp,
                                       chi2_mult=cfg.chi2_mult)
    parts = {"systems": systems, "project": project, "gate": gate, "compress": compress, "ekf_update": update,
             "msckf_update": whole}
    if hasattr(msckf, "msckf_update_ref"):
        parts["plain"] = lambda: msckf.msckf_update_ref(st, L, cfg.cam_model, fb.msckf_uv, fb.msckf_mask,
                                                        sigma_pix=sp, chi2_mult=cfg.chi2_mult)
    rec = {"features": int(obs_mask.any(-1).any(-1).sum()), "kept": int(keep.sum()), "rows_a_feature": 2 * K * C}
    for name, fn in parts.items():
        rec[f"{name}_ms"] = graph_ms(fn, k=10, replays=5)
    rec["kernels"] = {name: kernels_of(fn) for name, fn in parts.items()}
    return rec


if __name__ == "__main__":
    sys.exit(main())

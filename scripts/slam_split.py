#!/usr/bin/env python3
"""The SLAM stage's split on a benchmark cell's own state: `slam_update`
and `slam_delayed_init`, each graphed alone, by the graph clock.

    python3 scripts/slam_split.py [--workload euroc_v101.klt_live] [--seed N] [--frame 40] [--root DIR]

Makes the cell's traffic and drives its estimator as fast as it goes.
The first frame from `--frame` on whose plan has SLAM candidates is kept
as the fused step receives it (the manager's state and the frame's
fields); the step's stages before SLAM (the UWB drain, propagate+clone,
the MSCKF update) then run on it eagerly, and each of these is timed by
`chip_smoke.graph_ms` (L2 warm, as on the main path):

  * `slam_update_ms`: `slam_update` on that state;
  * `slam_delayed_init_ms`: `slam_delayed_init` on the state
    `slam_update` leaves (the kernel's route and its batched part, where
    the program has the kernel; the plain loop where it has not);
  * where the program has the kernel: `plain_ms`, its plain version
    `slam_delayed_init_ref` on the same state and card.

The kernel alone, against its plain version and its bound, is timed by
chip_smoke.py's `full_step` phase.

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
    traffic = drv.make_traffic(config, dict(mix, warmup_s=(args.frame + 40) / 20.0), args.seed, 0.05,
                               harness.BENCH_DIR, frames=1)
    est = drv.Estimator(harness.program_package(drv.MODULES), config, traffic, harness.BENCH_DIR, dev)
    mgr = est.mgr
    kept = []
    full = mgr._jit_full

    def keep(state, fields):
        k = len(keep.frames)
        keep.frames.append(k)
        if not kept and k >= args.frame and (np.asarray(fields["cand_ids"]) >= 0).any():
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
        raise RuntimeError(f"no frame from {args.frame} on had SLAM candidates")
    state, fields, time_host, frame = kept[0]
    torch.cuda.synchronize()

    cfg = mgr._full_cfg
    L = cfg.layout
    fb = pipeline.bundle_from_numpy(fields, dev, state.cov.dtype)
    st, _, _ = pipeline._uwb_drain(state, fb, pipeline.plan_frame(fields, time_host), cfg)
    st = propagate_and_clone(st, L, fb.imu_t, fb.imu_w, fb.imu_a, cfg.noises, cfg.gravity_mag,
                             integration=cfg.integration, stamp_time=fb.stamp_time)
    st, _ = msckf_update(st, L, cfg.cam_model, fb.msckf_uv, fb.msckf_mask, sigma_pix=cfg.sigma_pix,
                         chi2_mult=cfg.chi2_mult)
    kw = dict(sigma_pix=cfg.sigma_pix, chi2_mult=cfg.chi2_mult)
    update = lambda: slam.slam_update(st, L, fb.slam_uv, fb.slam_mask, cfg.cam_model, **kw)
    st_u, uinfo = update()
    init_args = (L, fb.cand_uv, fb.cand_mask, fb.cand_slots, fb.cand_ids, cfg.cam_model)
    init = lambda: slam.slam_delayed_init(st_u, *init_args, **kw)
    _, iinfo = init()
    rec = {"card": torch.cuda.get_device_name(0), "root": root, "workload": args.workload, "seed": args.seed,
           "frame": frame, "dim": L.dim, "max_slam": L.max_slam, "dtype": str(state.cov.dtype),
           "landmarks_in_state": int(st.slam_valid.sum()),
           "landmarks_with_observations": int(fb.slam_mask.any(-1).any(-1).sum()),
           "candidates": int((fb.cand_ids >= 0).sum()), "inited": int(iinfo["inited"].sum()),
           "slam_update_ms": graph_ms(update, k=10, replays=5),
           "slam_delayed_init_ms": graph_ms(init, k=10, replays=5)}
    if hasattr(slam, "slam_delayed_init_ref"):
        rec["plain_ms"] = graph_ms(lambda: slam.slam_delayed_init_ref(st_u, *init_args, **kw), k=10, replays=5)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

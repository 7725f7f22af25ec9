#!/usr/bin/env python3
"""The front end's two hand kernels on a benchmark cell's own frames, by the
graph clock, and the share of their rooflines they reach.

    python3 scripts/cell_kernels.py [--workload euroc_v101.klt_live] [--seed N] [--frames 40]

Makes the cell's traffic, feeds its first `--frames` frames through the
cell's `KLTTracker` (its driver's `Estimator`), then times `fast9` on the
last frame's equalized image and `lk_track` from the frame before's
pyramid to the last one's for the tracks alive before it, each by
`chip_smoke.graph_ms` (100 launches in one CUDA graph, replayed warm: L2
warm, as on the main path). Prints one JSON line: ms a launch, the work
(`port_bench/rooflines.py`) and the shares. Needs the card.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="euroc_v101.klt_live")
    ap.add_argument("--seed", type=int, default=2147483647)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cell_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import graph_ms
    from port_bench import harness, rooflines
    from uvio_tpu_torch.frontend import kernels
    from uvio_tpu_torch.frontend.tracker import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, config, mix = harness.cell_files(args.workload)
    drv = harness.cell_driver(config, mix)
    traffic = drv.make_traffic(config, dict(mix, warmup_s=(args.frames - 1) / 20.0), args.seed, 0.05,
                               harness.BENCH_DIR, frames=1)
    est = drv.Estimator(harness.program_package(drv.MODULES), config, traffic, harness.BENCH_DIR, "cuda:0")
    tr = est.tracker
    stream = traffic.stream
    for k in range(args.frames - 1):
        tr.feed(float(stream.cam_t[k]), traffic.images[k].astype(np.float32))
    uv, active = tr._table()
    prev_pyr = tr.prev_pyr
    img_e, pyr = tr._prepare(to_device(traffic.images[args.frames - 1].astype(np.float32), tr.device))
    H, W = img_e.shape
    survivors = int(kernels.fast_pretest(img_e, tr.fast_thresh)[3:H - 3, 3:W - 3].sum())
    fast_ms = graph_ms(lambda: kernels.fast_score(img_e, tr.fast_thresh))
    lk_ms = graph_ms(lambda: kernels.lk_track(prev_pyr, pyr, uv, active, half=tr.half))
    n = int(active.sum())
    fast_b, fast_f = rooflines.fast9_bytes(H, W), rooflines.fast9_flops(H, W, survivors)
    lk_f = rooflines.lk_track_flops(tr.cap, tr.half, len(pyr))
    out = {"card": torch.cuda.get_device_name(0), "image": [H, W], "features": tr.cap, "active": n,
           "levels": len(pyr), "pretest_survivors": survivors,
           "fast9_ms": fast_ms, "fast9_bytes": fast_b, "fast9_flops": fast_f,
           "fast9_bound_ms": rooflines.bound_ms(fast_f, fast_b),
           "fast9_roofline_pct": rooflines.roofline_pct(fast_ms, fast_f, fast_b),
           "lk_track_ms": lk_ms, "lk_track_flops": lk_f, "lk_track_bound_ms": rooflines.bound_ms(lk_f),
           "lk_track_roofline_pct": rooflines.roofline_pct(lk_ms, lk_f)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

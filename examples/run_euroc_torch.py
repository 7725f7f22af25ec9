"""Run the PyTorch port on a EuRoC/TUM-VI ASL-format dataset folder
(`examples/run_euroc.py` through `uvio_tpu_torch`).

Deterministic offline processing of a recorded sequence with a
reference-style config directory: images -> `KLTTracker` (the FAST-9 and
Lucas-Kanade kernels on the card) -> a self-initialising `VioManager` or
`UVioManager` -> a TUM trajectory, and (if groundtruth is present) ATE.

Usage:
    PYTHONPATH=. python examples/run_euroc_torch.py <dataset_root> <config_dir> \
        [--out est.txt] [--max-frames N] [--cpu]
    PYTHONPATH=. python examples/run_euroc_torch.py --synthetic DIR [--cpu]

`--synthetic DIR` first renders a 16 s ASL dataset and its config into
DIR from the port's simulator (the stand-in for a EuRoC sequence that
`uvio_tpu`'s regression uses) and then runs on it. It runs on cuda:0
unless --cpu is given.
"""

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset_root", nargs="?")
    ap.add_argument("config_dir", nargs="?")
    ap.add_argument("--synthetic", metavar="DIR", default=None,
                    help="render a synthetic dataset into DIR and run on it")
    ap.add_argument("--out", default="est.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--align", default="se3", choices=["none", "posyaw", "se3", "sim3"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    args = ap.parse_args()

    import torch

    from uvio_tpu_torch.eval import ate
    from uvio_tpu_torch.utils.euroc import EurocDataset, run_euroc, write_synthetic_dataset

    # the filter's float32 products must be full precision (README "Numerics")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.synthetic:
        base = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "data", "streams", "mono", "config")
        args.dataset_root, args.config_dir = write_synthetic_dataset(args.synthetic, base)
    elif not (args.dataset_root and args.config_dir):
        ap.error("give <dataset_root> <config_dir>, or --synthetic DIR")
    t, q, p = run_euroc(
        args.dataset_root, args.config_dir, out_path=args.out,
        max_frames=args.max_frames, device="cpu" if args.cpu else None,
    )
    print(f"processed {len(t)} frames -> {args.out}")
    gt = EurocDataset(args.dataset_root).groundtruth()
    if gt is not None and len(t):
        res = ate(t, q, p, gt["t"], gt["q_GtoI"], gt["p"], method=args.align)
        print(
            f"ATE ({args.align}): rmse_pos = {res['rmse_pos']:.4f} m | "
            f"rmse_ori = {res['rmse_ori_deg']:.4f} deg | n = {res['n']}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

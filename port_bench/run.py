"""Run one cell of the benchmark of `uvio_tpu_torch` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. It needs an NVIDIA GPU
and exits with an error, printing no result, without one. The last line
of standard output is the result (JSON): `correct`, `attempted`,
`failed`, `metrics`, `device` and, traced, `breakdown`; last in it,
`checks`, each number compared with the reference beside its limit,
which also close standard error.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the caches of what the run builds stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, "build", "port_bench", sub))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("port_bench: no CUDA device; the benchmark measures the card and has no CPU mode",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from port_bench.harness import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", PROCESS_START)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

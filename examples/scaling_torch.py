"""Scaling of the port over sequences and processes, on real workloads.

The port's twin of `examples/scaling.py`, on one card (or the CPU):

1. **Batched filter throughput** (`run_filter_dp`): B independent
   sequences of `bench.py`'s scenario run the full step (UWB drain,
   propagate+clone, MSCKF, SLAM, marginalization) as one batched step,
   `pipeline.make_batched_full_step`, in float32. The inputs are the
   committed fixture's four captured sequences (`fixtures/batched_seeds.npz`:
   seeds 7-10, each after its own warm-up) tiled to B, so no two
   neighbouring sequences are copies of one another. For B = 1, 4, 16, 32
   it reports sequence-frames/s, ms per batched step, kernel launches per
   step (`torch.profiler`, on a card) and peak device memory. With
   `--nproc N` the batch is split over N processes (the "dp" axis: the
   default process group): gloo on the CPU, NCCL with one card a process.
2. **Bundle adjustment** (`run_ba_strong`): one fixed map of 32 keyframes
   x 2048 landmarks, 8 iterations of `parallel.ba.ba_solve`, seconds per
   solve; with `--nproc N` over a ("kf", "lm") grid of N processes.
3. `--multiproc`: the 2-process sharded BA over gloo against the
   one-process solve's final cost, with the communication table.

    python examples/scaling_torch.py --write /tmp/scaling.json   # cuda:0
    python examples/scaling_torch.py --cpu --nproc 2             # gloo

`--write` writes the table as JSON with the platform and, on a card, the
`nvidia-smi` name and power limit.
"""

import argparse
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches(fn, dev):
    """Kernel launches of fn(), by `torch.profiler` (None off a card)."""
    if dev.type != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    keys = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"}
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    return sum(e.name() in keys for e in prof.profiler.kineto_results.events())


def run_filter_dp(B, dev, frames=40, reps=3, group=None):
    """Throughput of the batched full step on B sequences, float32 (one
    warm pass over `frames` frames, then `reps` timed ones from the same
    state): sequence-frames/s, ms per batched step, kernel launches of
    one step and peak device memory (None off a card)."""
    import torch

    from uvio_tpu_torch.fixtures import load_batched_fixture, stage_batched_fixture
    from uvio_tpu_torch.pipeline import FullStepConfig, make_batched_full_step

    fx = load_batched_fixture()
    if frames > len(fx.bundles):
        raise ValueError(f"the fixture holds {len(fx.bundles)} frames, not {frames}")
    state0, staged = stage_batched_fixture(fx, B, frames, dev, torch.float32)
    step = make_batched_full_step(FullStepConfig.from_dict(fx.config), group)

    def run():
        st = state0
        for fb, plan in staged:
            st, _ = step(st, fb, plan)
        return st

    run()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    _sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    fb, plan = staged[min(1, frames - 1)]
    return {"seq_frames_per_s": B * frames * reps / wall, "ms_per_step": wall / (frames * reps) * 1e3,
            "launches_per_step": _launches(lambda: step(state0, fb, plan), dev),
            "peak_memory_bytes": peak}


def ba_problem(N=8, L=64, seed=3):
    """`examples/scaling.py`'s map: N keyframes on a circle looking at the
    origin, L landmarks in a 3 m cube, 1e-3 noise on the normalized
    observations, landmarks perturbed by 0.1 m. (q, p, lm0, obs, mask,
    lm) as numpy."""
    import torch

    from uvio_tpu_torch.math import rot_to_quat

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    p = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * np.sin(2 * th)], axis=1)
    lm = rng.uniform(-1.5, 1.5, (L, 3))
    Rs = []
    for k in range(N):
        z = -p[k] / np.linalg.norm(p[k])
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z]))
    R = np.stack(Rs)
    q = rot_to_quat(torch.as_tensor(R)).numpy()
    pc = np.einsum("nij,lnj->lni", R, lm[:, None, :] - p[None, :, :])
    mask = pc[..., 2] > 0.5
    obs = pc[..., :2] / np.where(np.abs(pc[..., 2:]) < 1e-3, 1e-3, pc[..., 2:])
    obs += 1e-3 * rng.standard_normal(obs.shape)
    lm0 = lm + 0.1 * rng.standard_normal(lm.shape)
    return q, p, lm0, obs, mask, lm


def _ba_mesh(n):
    """`examples/scaling.py`'s grid: landmarks first, keyframes split in
    two past 4 processes."""
    from uvio_tpu_torch.parallel.distributed import make_ba_mesh

    return make_ba_mesh(1 if n <= 4 else 2)


def run_ba_strong(dev, N=32, L=2048, iters=8, reps=3, mesh=None):
    """Seconds per `ba_solve` of one fixed map (one warm solve first)."""
    import torch

    from uvio_tpu_torch.parallel.ba import BAOptions, ba_solve

    q, p, lm0, obs, mask, _ = ba_problem(N, L, seed=0)
    t = lambda a, dtype=torch.float64: torch.as_tensor(a, dtype=dtype, device=dev)
    args = (t(q), t(p), t(lm0), t(obs), t(mask, torch.bool))
    opts = BAOptions(iters=iters)
    ba_solve(*args, opts, mesh=mesh)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = ba_solve(*args, opts, mesh=mesh)
    out[3]["costs"].cpu()
    return (time.perf_counter() - t0) / reps


def _init(rank, world, port, cpu):
    """Join the process group: gloo on the CPU, NCCL with card `rank`."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cpu:
        dev, backend = torch.device("cpu"), "gloo"
    else:
        dev, backend = torch.device(f"cuda:{rank}"), "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    return dev


def _worker(rank, world, port, cpu, task, kwargs, out):
    """One process of a `--nproc` run; rank 0 writes the result to `out`."""
    import torch.distributed as dist

    from uvio_tpu_torch.parallel.distributed import print_comm_table

    dev = _init(rank, world, port, cpu)
    try:
        if task == "filter":
            res = run_filter_dp(dev=dev, group=dist.group.WORLD, **kwargs)
        elif task == "ba":
            res = run_ba_strong(dev, mesh=_ba_mesh(world), **kwargs)
        else:  # the multi-process demo: the sharded solve against one process
            import torch

            from uvio_tpu_torch.parallel.ba import BAOptions, ba_solve
            from uvio_tpu_torch.parallel.distributed import make_ba_mesh

            q, p, lm0, obs, mask, _ = ba_problem(N=8, L=64)
            mesh = make_ba_mesh()
            t = lambda a, dtype=torch.float64: torch.as_tensor(a, dtype=dtype, device=dev)
            _, _, _, info = ba_solve(t(q), t(p), t(lm0), t(obs), t(mask, torch.bool), BAOptions(iters=6),
                                     mesh=mesh)
            costs = info["costs"].cpu().numpy()
            res = {"mesh": dict(zip(mesh.axis_names, mesh.shape)), "cost0": float(costs[0]),
                   "cost1": float(costs[-1])}
            if rank == 0:
                print_comm_table(8, 64, mesh.size("kf"), mesh.size("lm"))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_procs(n, task, cpu, **kwargs):
    """Run `task` over n processes (spawned, meeting at a free localhost
    port); rank 0's result."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.spawn(_worker, args=(n, port, cpu, task, kwargs, out), nprocs=n, join=True)
        with open(out) as f:
            return json.load(f)


def run_multiproc():
    """The 2-process sharded BA over gloo, checked against the
    one-process final cost (`examples/scaling.py --multiproc`)."""
    import torch

    from uvio_tpu_torch.parallel.ba import BAOptions, ba_solve

    q, p, lm0, obs, mask, _ = ba_problem(N=8, L=64)
    t = lambda a, dtype=torch.float64: torch.as_tensor(a, dtype=dtype)
    _, _, _, info = ba_solve(t(q), t(p), t(lm0), t(obs), t(mask, torch.bool), BAOptions(iters=6))
    expect = float(info["costs"][-1])
    res = run_procs(2, "multiproc", True)
    ok = res["cost1"] < 0.05 * res["cost0"] and abs(res["cost1"] - expect) < 1e-6 + 1e-3 * abs(expect)
    print(f"[multiproc] mesh {res['mesh']} procs=2 cost {res['cost0']:.3e} -> {res['cost1']:.3e} "
          f"(single-proc {expect:.3e}) {'OK' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("the 2-process solve disagrees with the one-process solve")
    print("multiproc demo: 2 processes OK")
    return {**res, "single_process_cost": expect}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    ap.add_argument("--batches", default="1,4,16,32", help="comma list of batch sizes B")
    ap.add_argument("--frames", type=int, default=40, help="frames a pass (the fixture holds 40)")
    ap.add_argument("--reps", type=int, default=3, help="timed passes of each B")
    ap.add_argument("--nproc", type=int, default=1, help="processes of the dp split and the BA grid")
    ap.add_argument("--ba-reps", type=int, default=3, help="timed BA solves")
    ap.add_argument("--multiproc", action="store_true", help="run the 2-process BA demo only")
    ap.add_argument("--write", default=None, help="write the table as JSON to this path")
    args = ap.parse_args(argv)

    import subprocess

    import torch

    from uvio_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.multiproc:
        run_multiproc()
        return
    cuda = dev.type == "cuda"
    if cuda and args.nproc > torch.cuda.device_count():
        raise SystemExit(f"--nproc {args.nproc} needs {args.nproc} cards (NCCL), this host has "
                         f"{torch.cuda.device_count()}; add --cpu for gloo")
    results = {"platform": "gpu" if cuda else "cpu", "nproc": args.nproc, "frames": args.frames,
               "dtype": "float32", "filter_dp": {}, "filter_dp_seq_frames_per_s": {},
               "ba_strong_solve_s": {}}
    if cuda:
        results["device"] = torch.cuda.get_device_name(dev)
        results["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    batches = [int(b) for b in args.batches.split(",")]
    for B in batches:
        kw = dict(B=B, frames=args.frames, reps=args.reps)
        r = run_procs(args.nproc, "filter", not cuda, **kw) if args.nproc > 1 else run_filter_dp(dev=dev, **kw)
        results["filter_dp"][B] = r
        results["filter_dp_seq_frames_per_s"][B] = r["seq_frames_per_s"]
    kw = dict(reps=args.ba_reps)
    results["ba_strong_solve_s"][args.nproc] = (
        run_procs(args.nproc, "ba", not cuda, **kw) if args.nproc > 1 else run_ba_strong(dev, **kw))

    where = f"{results['platform']}, {args.nproc} process{'es' if args.nproc > 1 else ''}"
    print(f"\n== full step, B independent sequences in one batched step [{where}] ==")
    print(f"{'B':>4} {'seq-frames/s':>14} {'ms/step':>9} {'launches':>9} {'peak MB':>9}")
    for B in batches:
        r = results["filter_dp"][B]
        fmt = lambda x, f: "-" if x is None else format(x, f)
        print(f"{B:>4} {r['seq_frames_per_s']:>14.1f} {r['ms_per_step']:>9.2f} "
              f"{fmt(r['launches_per_step'], '>9d')} {fmt(None if r['peak_memory_bytes'] is None else r['peak_memory_bytes'] / 1e6, '>9.1f')}")
    for n, s in results["ba_strong_solve_s"].items():
        print(f"\n== BA (32 kf x 2048 lm, 8 iterations) [{where}] ==\n{n:>8} processes {s:>9.3f} s a solve")
    if args.write:
        with open(args.write, "w") as f:
            json.dump(results, f, indent=1)
        print(f"\nwrote {args.write}")
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Write the replay fixture of the batched full filter step,
`uvio_tpu_torch/fixtures/batched_seeds.npz`.

    JAX_PLATFORMS=cpu python scripts/make_batched_fixture.py [--out PATH]

Runs `uvio_tpu` (JAX, on the CPU) only. `capture_sim_bundles` captures
`bench.py`'s scenario (25 SLAM slots, 4 biased UWB anchors, 4 range sets
and 40 MSCKF features a frame) under four seeds, float64, each after its
own number of warm-up frames (`SEEDS`, `WARM`), then `N_FRAMES` bundles.
The four runs are stacked into one batch (a leading sequence axis B) and
replayed through `jax.vmap(pipeline.full_filter_step)` twice from the
same stacked state: in float64, and with the state cast to float32 (the
time axis stays float64), the precision `bench.py` runs.

The warm-ups differ so that the four sequences' plans differ: the
sequence with 5 warm-up frames has no full clone ring at first, so it
does not marginalize while the others do, and the 20/21/22-frame ones
meet the frames whose UWB drain has one range set more or fewer on
different steps. The script checks that on some frame the plans differ
in a UWB row, in SLAM delayed init and in marginalization, and fails
otherwise: a batch whose plans agree would leave the batched step's
per-sequence selects untested.

The file holds, as plain numpy arrays (`uvio_tpu_torch.fixtures` loads
it without JAX):
  config_json        the FullStepConfig, its StateLayout and noises
  seeds, warm        the four seeds and their warm-up frame counts
  state0_<field>     the stacked state before the first bundle, (B, ...)
  fb_<field>         the bundles, (frames, B, ...)
  f64_<key>, f32_<key>   per frame and sequence of each replay,
                     (frames, B, ...): q, p, v, cov_trace, cov_ok,
                     zupt_accepted, msckf_tri_ok, msckf_kept,
                     msckf_num_used, msckf_cov_ok, slam_kept, slam_failed,
                     slam_inited, uwb_accepted, slam_valid
"""

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

SEEDS = (7, 8, 9, 10)
WARM = (20, 21, 22, 5)
N_FRAMES, MAX_SLAM = 40, 25
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "uvio_tpu_torch", "fixtures",
    "batched_seeds.npz",
)


def plan_bits(bundles, times):
    """Each sequence's decisions for one frame, `uvio_tpu`'s predicates on
    the bundle: (uwb rows (B, U): `any(mask) | (stamp > s.time)` with the
    state time moving to each row that runs; slam init (B,):
    `any(cand_ids >= 0)`; marg (B,): `marg_enable`)."""
    rows = []
    for b, t in zip(bundles, times):
        r = []
        for ts, rm in zip(np.asarray(b.uwb_stamp), np.asarray(b.uwb_mask)):
            run = bool(np.any(rm)) or float(ts) > t
            r.append(run)
            t = float(ts) if run else t
        rows.append(r)
    return (np.array(rows), np.array([bool(np.any(np.asarray(b.cand_ids) >= 0)) for b in bundles]),
            np.array([bool(b.marg_enable) for b in bundles]))


def _replay(step, state, frames):
    """Per-frame records, (frames, B, ...), of one replay of the stacked
    bundles through the vmapped JAX step."""
    recs = []
    for fb in frames:
        state, infos = step(state, fb)
        m = infos["msckf"]
        recs.append({
            "q": state.q, "p": state.p, "v": state.v,
            "cov_trace": np.trace(np.asarray(state.cov), axis1=1, axis2=2),
            "cov_ok": infos["cov_ok"], "zupt_accepted": infos["zupt_accepted"],
            "msckf_tri_ok": m["tri_ok"], "msckf_kept": m["kept"], "msckf_num_used": m["num_used"],
            "msckf_cov_ok": m["cov_ok"],
            "slam_kept": infos["slam_kept"], "slam_failed": infos["slam_failed"],
            "slam_inited": infos["slam_inited"], "uwb_accepted": infos["uwb_accepted"],
            "slam_valid": state.slam_valid,
        })
    return {k: np.stack([np.asarray(r[k]) for r in recs]) for k in recs[0]}


def make(out):
    from functools import partial

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import uvio_tpu  # noqa: F401  (x64)
    from uvio_tpu.eval.capture import capture_sim_bundles
    from uvio_tpu.pipeline import full_filter_step

    t0 = time.perf_counter()
    runs = [capture_sim_bundles(n_warm=w, n_bench=N_FRAMES, seed=s, max_slam=MAX_SLAM, dtype="float64")
            for s, w in zip(SEEDS, WARM)]
    cfg = runs[0][0]
    assert all(r[0] == cfg for r in runs), "the seeds give different FullStepConfigs"
    print(f"captured {len(SEEDS)} x {N_FRAMES} bundles in {time.perf_counter() - t0:.1f} s", flush=True)

    times = [float(r[1].time) for r in runs]
    differ = {"uwb_row": [], "slam_init": [], "marg": []}
    for k in range(N_FRAMES):
        bundles = [r[2][k] for r in runs]
        rows, init, marg = plan_bits(bundles, times)
        for name, bits in (("uwb_row", rows), ("slam_init", init), ("marg", marg)):
            if (bits != bits[:1]).any():
                differ[name].append(k)
        times = [float(b.stamp_time) for b in bundles]
    print(f"frames whose plans differ: {differ}", flush=True)
    missing = [name for name, frames in differ.items() if not frames]
    if missing:
        raise SystemExit(f"the sequences' plans never differ in {missing}: pick other seeds or warm-ups")

    stack = lambda *xs: jnp.stack(xs)
    state0 = jax.tree.map(stack, *[r[1] for r in runs])
    frames = [jax.tree.map(stack, *[r[2][k] for r in runs]) for k in range(N_FRAMES)]
    arrays = {"config_json": np.array(json.dumps(dataclasses.asdict(cfg))),
              "seeds": np.array(SEEDS), "warm": np.array(WARM)}
    for name in state0.__dataclass_fields__:
        arrays[f"state0_{name}"] = np.asarray(getattr(state0, name))
    for name in frames[0]._fields:
        arrays[f"fb_{name}"] = np.stack([np.asarray(getattr(fb, name)) for fb in frames])

    t0 = time.perf_counter()
    step = jax.jit(jax.vmap(partial(full_filter_step, cfg=cfg)))
    for k, v in _replay(step, state0, frames).items():
        arrays[f"f64_{k}"] = v
    keep64 = ("time", "clones_t")

    def to32(name, a):
        return a.astype(jnp.float32) if a.dtype == jnp.float64 and name not in keep64 else a

    state32 = state0.replace(**{n: to32(n, getattr(state0, n)) for n in state0.__dataclass_fields__})
    for k, v in _replay(step, state32, frames).items():
        arrays[f"f32_{k}"] = v
    print(f"replayed f64 and f32 in {time.perf_counter() - t0:.1f} s", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {os.path.getsize(out)} bytes", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    make(ap.parse_args().out)


if __name__ == "__main__":
    main()

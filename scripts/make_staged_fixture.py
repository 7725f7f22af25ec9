#!/usr/bin/env python3
"""Write the staged-path fixture, `uvio_tpu_torch/fixtures/staged_seed7.npz`.

    JAX_PLATFORMS=cpu python scripts/make_staged_fixture.py [--out PATH]

Runs `uvio_tpu` (JAX, on the CPU) once: the `bench.py` scenario of
`make_full_step_fixture.py` (seed 7, 4 biased UWB anchors with online
calibration, 25 SLAM slots, rk4, float64) live through the staged
`UVioManager` (`fused_step=False`): 20 warm-up frames, then 60 frames, each
recorded with `uvio_tpu_torch.fixtures.staged_record` (position,
quaternion, trace of the covariance, the MSCKF, SLAM and UWB decisions).
The file holds one (frames, ...) array per record key; the port's staged
manager on the same events reproduces it (`chip_smoke.py`, phase
`backend`; `tests/test_torch_staged.py`).
"""

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

from uvio_tpu_torch.fixtures import STAGED_FIXTURE, STAGED_FRAMES, STAGED_WARM, staged_record  # noqa: E402


def make(out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import uvio_tpu  # noqa: F401  (x64)
    from make_full_step_fixture import _drive, _manager, _simulator

    t0 = time.perf_counter()
    sim = _simulator()
    mgr = _manager(sim, fused_step=False)
    gt0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, gt0["q_GtoI"], gt0["p_IinG"], gt0["v_IinG"], gt0["bg"], gt0["ba"])
    _drive(sim, mgr, STAGED_WARM)
    recs, before = [], [mgr.__dict__.get("last_msckf_info")]

    def on_frame(tc):
        recs.append(staged_record(mgr, tc, np.asarray, before[0]))
        before[0] = mgr.__dict__.get("last_msckf_info")

    _drive(sim, mgr, STAGED_FRAMES, on_frame=on_frame)
    arrays = {k: np.stack([r[k] for r in recs]) for k in recs[0]}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {os.path.getsize(out)} bytes, {len(recs)} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=STAGED_FIXTURE)
    make(ap.parse_args().out)


if __name__ == "__main__":
    main()

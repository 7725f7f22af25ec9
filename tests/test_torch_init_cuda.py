"""The in-motion initializer's solver on the card: `solve_dynamic_init` on
`cuda:0` against the same solve on the CPU, float64, on a window of the
port's simulator (6 poses 0.3 s apart on the aggressive lap, 15 tracks,
noisy IMU and pixels, as `tests/test_dynamic_init.py` builds its window).
Params, `rmse_norm` and `rcond` within 1e-9 relative and the same
accepted Gauss-Newton steps. On the card the steps after the first replay
a captured CUDA graph of a step: the same solve with every step run
eagerly agrees with it to 1e-12 relative. Skips without a CUDA device.

Imports neither JAX nor `uvio_tpu`, so it runs on a machine with only
PyTorch; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_init_cuda.py
"""

import numpy as np
import pytest
import torch

from uvio_tpu_torch.filter.propagator import select_imu_readings_np
from uvio_tpu_torch.init import dynamic_init as D
from uvio_tpu_torch.init.dynamic_init import DynamicInitOptions, solve_dynamic_init
from uvio_tpu_torch.math import quat_to_rot
from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

pytestmark = pytest.mark.cuda


def make_window(n_pose=6, cam_dt=0.3, f_max=15, seed=0):
    sim = Simulator(SimParams(seed=5), trajectory=circle_trajectory(duration=14.0, lap_s=8.0))
    pose_times = sim.t_start + 1.0 + np.arange(n_pose) * cam_dt
    ts = np.arange(pose_times[0], pose_times[-1] + 0.02, 1.0 / 200.0)
    s = sim._state(ts)
    R = s["R_GtoI"].numpy()
    rng = np.random.default_rng(seed)
    w = s["w_IinI"].numpy() + 1.7e-4 * np.sqrt(200.0) * rng.standard_normal((len(ts), 3))
    a = np.einsum("nij,nj->ni", R, s["a_IinG"].numpy() + [0, 0, 9.81])
    a = a + 2.0e-3 * np.sqrt(200.0) * rng.standard_normal((len(ts), 3))
    M = 128
    imu = [np.stack(x) for x in zip(*[select_imu_readings_np(ts, w, a, pose_times[i], pose_times[i + 1], M)
                                      for i in range(n_pose - 1)])]
    st = sim._state(pose_times)
    R_GtoI, p_IinG = st["R_GtoI"].numpy(), st["p_IinG"].numpy()
    cam = sim.params.cameras[0]
    R_ItoC = quat_to_rot(torch.as_tensor(cam.q_ItoC)).numpy()
    pc = np.einsum("ij,pjk,fpk->fpi", R_ItoC, R_GtoI, sim.map_pts[:400, None] - p_IinG[None]) + cam.p_IinC
    uv = pc[..., :2] / pc[..., 2:]
    ok = (pc[..., 2] > 0.5).all(1) & (np.abs(uv) < 0.8).all((1, 2))
    obs = uv[ok][:f_max] + rng.standard_normal((f_max, n_pose, 2)) / 458.0
    return (*imu, obs, np.ones((f_max, n_pose), bool), R_ItoC, cam.p_IinC)


def test_solve_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    window = make_window()
    opts = DynamicInitOptions(max_features=15)
    out = {dev: solve_dynamic_init(*[torch.as_tensor(np.asarray(x), device=dev) for x in window], opts)
           for dev in ("cpu", "cuda:0")}
    cpu, gpu = out["cpu"], out["cuda:0"]
    assert gpu["params"]["v0"].device.type == "cuda"
    assert gpu["accepted"].tolist() == cpu["accepted"].tolist()
    for k in ("v0", "g", "bg", "ba", "feats"):
        a, b = gpu["params"][k].cpu().numpy(), cpu["params"][k].numpy()
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), k
    for k in ("rmse_norm", "rcond"):
        assert abs(float(gpu[k]) - float(cpu[k])) <= 1e-9 * abs(float(cpu[k])), k
    assert float(cpu["rmse_norm"]) < opts.max_reproj_rmse


def eager_steps(gn_step, x, lam, accepted):
    """`dynamic_init._gn_on_graph` without the graph: every step eagerly."""
    for i in range(accepted.shape[0]):
        x, lam, accepted[i] = gn_step(x, lam)
    return x, lam


def test_graph_replay_matches_eager_steps(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.as_tensor(np.asarray(x), device="cuda:0") for x in make_window()]
    opts = DynamicInitOptions(max_features=15)
    graph = solve_dynamic_init(*args, opts)
    monkeypatch.setattr(D, "_gn_on_graph", eager_steps)
    eager = solve_dynamic_init(*args, opts)
    assert graph["accepted"].tolist() == eager["accepted"].tolist()
    for k in ("v0", "g", "bg", "ba", "feats"):
        a, b = graph["params"][k], eager["params"][k]
        print(k, float((a - b).abs().max()))
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), k
    for k in ("rmse_norm", "rcond"):
        assert abs(float(graph[k]) - float(eager[k])) <= 1e-12 * abs(float(eager[k])), k

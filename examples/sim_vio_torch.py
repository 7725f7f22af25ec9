"""End-to-end simulated VIO run through the PyTorch port
(`examples/sim_vio.py`'s run through `uvio_tpu_torch`).

Generates seeded IMU, feature tracks and (with --uwb) ranges from the
port's B-spline simulator, runs the port's `VioManager` or `UVioManager`
initialized from groundtruth, and reports the absolute trajectory error
(`uvio_tpu_torch.eval.ate`) against the exact simulated trajectory (no
alignment: the estimate starts in the simulator's frame). With --klt the
tracks come from the port's KLT frontend on rendered frames instead of
the simulator's tracker; --record writes both trajectories in TUM format.

Usage:
    PYTHONPATH=. python examples/sim_vio_torch.py [--duration 30] [--cpu] [--klt] [--record DIR]

It runs on cuda:0 unless --cpu is given.
"""

import argparse
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of cuda:0")
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    ap.add_argument("--imu-hz", type=float, default=200.0)
    ap.add_argument("--cam-hz", type=float, default=10.0)
    ap.add_argument("--num-pts", type=int, default=50)
    ap.add_argument("--max-slam", type=int, default=0)
    ap.add_argument("--uwb", action="store_true", help="UWB-aided (UVIO) mode")
    ap.add_argument(
        "--klt", action="store_true",
        help="run the KLT frontend on rendered frames instead of the sim tracker",
    )
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--record", type=str, default=None,
                    help="directory to write est.txt/gt.txt TUM trajectories")
    args = ap.parse_args()

    import numpy as np
    import torch

    from uvio_tpu_torch.eval import ate, save_tum
    from uvio_tpu_torch.manager import CameraConfig, VioConfig, VioManager
    from uvio_tpu_torch.sim import SimParams, Simulator, circle_trajectory

    # the filter's float32 products must be full precision (README "Numerics")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    uwb_anchors = {}
    if args.uwb:
        from uvio_tpu_torch.eval.capture import UWB_ANCHORS as uwb_anchors
    sim = Simulator(
        SimParams(sim_freq_imu=args.imu_hz, sim_freq_cam=args.cam_hz, num_pts=args.num_pts,
                  seed=args.seed, uwb_anchors=uwb_anchors),
        trajectory=circle_trajectory(duration=args.duration + 6.0),
    )
    cam = sim.params.cameras[0]
    common = dict(
        max_clones=11, max_msckf_in_update=40, max_slam=args.max_slam,
        sigma_pix=sim.params.sigma_pix, dtype=args.dtype, device="cpu" if args.cpu else None,
        cameras=[CameraConfig(model=cam.model, intrinsics=cam.intrinsics, q_ItoC=cam.q_ItoC,
                              p_IinC=cam.p_IinC)],
    )
    if args.uwb:
        from uvio_tpu_torch.uwb_manager import AnchorConfig, UVioConfig, UVioManager

        rng = np.random.default_rng(1)
        anchors = [
            AnchorConfig(anchor_id=aid, p_AinG=p + rng.normal(scale=0.05, size=3),  # imperfect prior
                         prior_cov=np.diag([0.05**2] * 3 + [0.25**2, 0.025**2]))
            for aid, (p, g, a) in uwb_anchors.items()
        ]
        mgr = UVioManager(UVioConfig(max_anchors=len(anchors), anchors=anchors,
                                     sigma_range=sim.params.sigma_range, **common))
    else:
        mgr = VioManager(VioConfig(**common))
    gt0 = sim.get_gt_state(sim.t_start)
    mgr.initialize_with_gt(sim.t_start, gt0["q_GtoI"], gt0["p_IinG"], gt0["v_IinG"], gt0["bg"], gt0["ba"])

    tracker = None
    if args.klt:
        from uvio_tpu_torch.frontend.tracker import KLTTracker

        tracker = KLTTracker(cam.intrinsics, cam.model, num_features=120, grid=(6, 8),
                             device="cpu" if args.cpu else None)

    est_t, est_q, est_p, gt_q, gt_p = [], [], [], [], []
    t_wall0 = time.time()
    tc = sim.t_start
    while sim.ok() and tc - sim.t_start <= args.duration:
        r = sim.get_next_imu()
        if r is None:
            break
        t = r[0]
        mgr.feed_imu(*r)
        if args.uwb and sim.cur_uwb_t + 1.0 / sim.params.uwb_freq <= t:
            ru = sim.get_next_uwb()
            if ru is not None:
                mgr.feed_uwb(*ru)
        if sim.cur_cam_t + 1.0 / sim.params.sim_freq_cam <= t:
            rc = sim.get_next_cam()
            if rc is None:
                break
            tc, obs = rc
            if tracker is not None:
                obs = [tracker.feed(tc, sim.render_image(tc))]
            mgr.feed_features(tc, obs)
            q, p = mgr.get_pose()
            g = sim.get_gt_state(tc)
            est_t.append(tc), est_q.append(q), est_p.append(p)
            gt_q.append(g["q_GtoI"]), gt_p.append(g["p_IinG"])
            if len(est_p) % 50 == 0:
                ep = np.linalg.norm(est_p[-1] - gt_p[-1])
                print(f"t={tc - sim.t_start:6.2f}s frames={len(est_p)} |p_err|={ep:.3f} m")
    wall = time.time() - t_wall0

    frames = len(est_p)
    est_t, est_q, est_p = np.asarray(est_t), np.asarray(est_q, np.float64), np.asarray(est_p, np.float64)
    gt_q, gt_p = np.asarray(gt_q), np.asarray(gt_p)
    if args.record:
        import os

        os.makedirs(args.record, exist_ok=True)
        save_tum(os.path.join(args.record, "est.txt"), est_t, est_q, est_p)
        save_tum(os.path.join(args.record, "gt.txt"), est_t, gt_q, gt_p)
        print(f"recorded TUM trajectories to {args.record}/")
    res = ate(est_t, est_q, est_p, est_t, gt_q, gt_p, method="none")
    rmse_pos, rmse_ori = res["rmse_pos"], res["rmse_ori_deg"]
    print(f"\nframes={frames} wall={wall:.1f}s ({frames / wall:.1f} fps) on {mgr.device}, {args.dtype}")
    print(f"ATE  rmse_pos = {rmse_pos:.4f} m   rmse_ori = {rmse_ori:.3f} deg")
    return rmse_pos < 1.0


if __name__ == "__main__":
    sys.exit(0 if main() else 1)

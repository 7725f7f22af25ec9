"""Port parity of the live managers, frame by frame (the checks of
`test_torch_live_configs.py`), with online camera calibration: a stereo rig
whose extrinsics and intrinsics start off the truth and are estimated,
with SLAM in representation 3; and the camera-IMU time offset estimated
from a seed 10 ms off, frames stamped on a camera clock 20 ms behind the
IMU's, on a rate-modulated circle, with SLAM in representation 4. The
calibration states are compared at every frame with the rest of the state
(1e-8).
"""

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from test_torch_live_configs import SLAM, assert_slam_exercised, live_run
from test_torch_manager import JCam, TCam

from uvio_tpu_torch.math import rot_to_quat
from uvio_tpu_torch.sim import SimCamera

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False  # the step insists on full-float32 products


def test_rep3_stereo_with_extrinsic_and_intrinsic_calibration():
    """Both cameras start from the perturbed extrinsics of
    `tests/test_sim_e2e.py:297-299` and focal lengths 2 px off."""
    dR = Rotation.from_euler("xyz", [0.8, -0.6, 0.5], degrees=True).as_matrix()
    q_pert = rot_to_quat(torch.as_tensor(dR, dtype=torch.float64)).numpy()
    p_pert = np.array([0.01, -0.008, 0.012])
    truth = [SimCamera(), SimCamera(p_IinC=np.array([-0.11, 0.0, 0.0]))]

    def seeded(Cam):
        return [Cam(model=c.model, intrinsics=c.intrinsics + np.r_[2.0, 2.0, np.zeros(6)], q_ItoC=q_pert,
                    p_IinC=c.p_IinC + p_pert) for c in truth]

    pair, counts = live_run(14, 4, dict(SLAM, feat_rep_slam=3, calib_cam_pose=True, calib_cam_intrinsics=True),
                            params=dict(cameras=truth), jextra=dict(cameras=seeded(JCam)),
                            textra=dict(cameras=seeded(TCam)))
    L = pair.t.layout
    assert L.num_cams == 2 and L.calib_cam_pose and L.calib_cam_intrinsics
    assert sum(b["msckf_mask"][:, :, 1].any() for b in pair.tb) >= 5  # the second camera is in the updates
    st = pair.t.state
    assert not np.allclose(st.calib_cam_q.numpy(), q_pert)  # the calibration moved
    assert not np.allclose(st.calib_cam_intr.numpy()[:, :4], np.stack([c.intrinsics for c in seeded(TCam)])[:, :4])
    assert_slam_exercised(pair, counts, 3)


def test_rep4_with_time_offset_calibration():
    dt_true = 0.02
    pair, counts = live_run(14, 4, dict(SLAM, feat_rep_slam=4, calib_cam_timeoffset=True, camimu_dt=dt_true - 0.010),
                            traj=dict(rate_mod=0.45), t_shift=dt_true)
    dt = float(pair.t.state.calib_dt)
    assert dt != dt_true - 0.010 and pair.t._dt_host == dt  # estimated, and mirrored on the host
    assert_slam_exercised(pair, counts, 4)

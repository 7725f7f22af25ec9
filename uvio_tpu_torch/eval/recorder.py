"""State / covariance / groundtruth stream recorder.

Port of `uvio_tpu/eval/recorder.py`, the reference's output-side
persistence: the TUM pose recorder (`ov_eval/src/utils/Recorder.h`) and
the total-state recorder
(`ov_msckf/src/ros/ROSVisualizerHelper.cpp:159-260`,
`sim_save_total_state_to_file`), which writes three whitespace text
streams per run:

    est.txt  : t q(4,JPL xyzw) p(3) v(3) bg(3) ba(3) [dt_camimu]
               [cam intr(8) extr(7) per camera]
    std.txt  : t sigma_q(3) sigma_p(3) sigma_v(3) sigma_bg(3)
               sigma_ba(3) [sigma_dt] [sigma_intr(8) sigma_extr(6)]
    gt.txt   : same layout as est.txt (true values)

These feed `error_simulation` / `ResultSimulation`-style consistency
analysis (NEES, 3-sigma bounds, calibration convergence).
"""

from __future__ import annotations

import os

import numpy as np

HEADER_EST = (
    "# timestamp(s) q_x q_y q_z q_w p_x p_y p_z v_x v_y v_z "
    "bg_x bg_y bg_z ba_x ba_y ba_z [dt_camimu cam0_intr(8) cam0_extr(7) ...]"
)
HEADER_STD = (
    "# timestamp(s) sq_x sq_y sq_z sp_x sp_y sp_z sv_x sv_y sv_z "
    "sbg_x sbg_y sbg_z sba_x sba_y sba_z [s_dt s_intr(8) s_extr(6) ...]"
)


class StateRecorder:
    """Streams estimator rows to est/std(/gt) files in a directory."""

    def __init__(self, outdir: str, record_gt: bool = True):
        os.makedirs(outdir, exist_ok=True)
        self.f_est = open(os.path.join(outdir, "state_est.txt"), "w")
        self.f_std = open(os.path.join(outdir, "state_std.txt"), "w")
        self.f_gt = (
            open(os.path.join(outdir, "state_gt.txt"), "w") if record_gt else None
        )
        self.f_est.write(HEADER_EST + "\n")
        self.f_std.write(HEADER_STD + "\n")
        if self.f_gt is not None:
            self.f_gt.write(HEADER_EST + "\n")

    @staticmethod
    def _row(t, q, p, v, bg, ba, extra=()):
        vals = [float(t)] + [float(x) for x in np.concatenate([q, p, v, bg, ba])]
        vals += [float(x) for x in extra]
        return " ".join(f"{x:.9g}" for x in vals) + "\n"

    def write_est(self, t, q, p, v, bg, ba, extra=()):
        self.f_est.write(self._row(t, q, p, v, bg, ba, extra))

    def write_std(self, t, sq, sp, sv, sbg, sba, extra=()):
        vals = [float(t)] + [
            float(x) for x in np.concatenate([sq, sp, sv, sbg, sba])
        ]
        vals += [float(x) for x in extra]
        self.f_std.write(" ".join(f"{x:.9g}" for x in vals) + "\n")

    def write_gt(self, t, q, p, v, bg, ba, extra=()):
        if self.f_gt is not None:
            self.f_gt.write(self._row(t, q, p, v, bg, ba, extra))

    def close(self):
        self.f_est.close()
        self.f_std.close()
        if self.f_gt is not None:
            self.f_gt.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _load_rows(path):
    """The numeric rows of a whitespace- or comma-separated text file,
    cut to the shortest row's length, as one array."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.replace(",", " ").split()])
    n_min = min(len(r) for r in rows)
    return np.asarray([r[:n_min] for r in rows])


def load_state_file(path):
    """Load a state_est/state_gt file -> (t, q, p, v, bg, ba, extra).

    extra is the ragged tail (calibration columns) as a (N, K) array,
    K possibly 0. Mirrors `ov_eval::Loader::load_simulation`.
    """
    arr = _load_rows(path)
    return (arr[:, 0], arr[:, 1:5], arr[:, 5:8], arr[:, 8:11], arr[:, 11:14], arr[:, 14:17],
            arr[:, 17:])


def load_std_file(path):
    """Load a state_std file -> (t, sq, sp, sv, sbg, sba, extra)."""
    arr = _load_rows(path)
    return (arr[:, 0], arr[:, 1:4], arr[:, 4:7], arr[:, 7:10], arr[:, 10:13], arr[:, 13:16],
            arr[:, 16:])

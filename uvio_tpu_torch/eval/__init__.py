from .recorder import StateRecorder, load_state_file, load_std_file
from .simres import error_simulation, format_report
from .timing import (
    load_timing_csv,
    timing_comparison,
    timing_flamegraph,
    timing_histogram,
    timing_percentages,
)
from .traj import ate, intersect, load_tum, nees, rpe, save_tum, umeyama_align

__all__ = [
    "StateRecorder",
    "ate",
    "error_simulation",
    "format_report",
    "intersect",
    "load_state_file",
    "load_std_file",
    "load_timing_csv",
    "load_tum",
    "nees",
    "rpe",
    "save_tum",
    "timing_comparison",
    "timing_flamegraph",
    "timing_histogram",
    "timing_percentages",
    "umeyama_align",
]

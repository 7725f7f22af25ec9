"""What a trace's summary reads, on made-up events: an idle gap inside a
frame is named by the driver's stage it falls in."""

import pytest

from port_bench import harness
from port_bench.trace import summarize

MS = 1_000_000  # ns


class Recorded:
    """A finished `Tracer`: its events only."""

    def __init__(self, events):
        self.events = events


def frame_gaps(stages, timing):
    """The named idle gaps, longest first, of a 10 ms frame whose device
    work leaves gaps centred at 1.05, 2.75, 4.0, 6.95 and 9.5 ms, and of
    the wait after it."""
    busy = [(0.0, 0.5), (1.6, 2.5), (3.0, 3.5), (4.5, 5.2), (8.7, 9.3), (9.7, 9.9), (100.0, 100.5)]
    events = [("frame", False, 0, 10 * MS), ("frame", False, 100 * MS, 101 * MS)]
    events += [("kernel", True, int(a * MS), int(b * MS)) for a, b in busy]
    return summarize(Recorded(events), [timing, timing], stages).idle_gaps


@pytest.mark.parametrize("post_s", [0.002, 0.0])
def test_corridor_gaps_keep_their_names(post_s):
    """The `vio` driver's stages name the gaps as the harness always has;
    a gap past the last stage's end falls in the last stage."""
    stages = harness.driver("vio").STAGES
    gaps = frame_gaps(stages, {"build_s": 0.002, "step_s": 0.006, "post_s": post_s})
    step = "frame: step (dispatch to read-back)"
    assert [n for n, _ in gaps] == ["between events (waiting for the sensors)", step, "frame: host bundle build",
                                    step, step, "frame: host bookkeeping"]
    assert [round(s * 1e3, 6) for _, s in gaps] == [90.1, 3.5, 1.1, 1.0, 0.5, 0.4]


def test_another_systems_stages_name_its_gaps():
    gaps = frame_gaps((("feed_s", "tracker feed"), ("rest_s", "filter")), {"feed_s": 0.003, "rest_s": 0.007})
    assert [n for n, _ in gaps][1:] == ["frame: filter", "frame: tracker feed", "frame: filter", "frame: tracker feed",
                                        "frame: filter"]

"""One switch for the program's own timing: host spans on the profiler's
clock, and device marks inside the captured CUDA graphs.

The switch is off by default and fixed per process: turn it on with
`enable()` before a manager is built. A manager and each graphed
callable (`graphs.Graphed`) read it once, when they are made.

Off, `span(name)` returns one shared no-op context and `mark(name)` does
nothing; a manager still stamps its frame's host spans with
`time.perf_counter` into its `last_timing` row. On:

  * `span(name)` opens a `torch.profiler.record_function` range named
    `uvio/<name>` while a profiler records, so a trace lays the program's
    spans on the same clock as the kernels they launch. Without one it is
    the no-op too: a range costs tens of µs a call on a busy host (PERF.md
    §5), and nothing would keep it;
  * `mark(name)`, called inside a graphed callable's capture, records a
    timing event on the capturing stream, which becomes an event-record
    node of the graph. The callable keeps the capture's marks with its
    graph and records one event before and one after each replay;
    `stage_ms` turns one replay's events into ms between consecutive
    events once the caller has waited for the stream. A mark names the
    stage that ends at it.

There is no log of its own: the manager's `last_timing` row is the
record (`manager.VioManager._record_fused_timing`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Tuple

import torch

PREFIX = "uvio/"

_on = False
_local = threading.local()  # .marks: the capture's [(name, event)], or None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def enable(on: bool = True):
    """Turn tracing on (or off) for the managers built after."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _range(name: str):
    if not torch._C._autograd._profiler_enabled():
        return NO_SPAN
    return torch.profiler.record_function(PREFIX + name)


def _no_range(name: str):
    return NO_SPAN


def span_for(on: bool):
    """`span` as an object built with the switch at `on` keeps it."""
    return _range if on else _no_range


def span(name: str):
    """The profiler range `uvio/<name>` when tracing is on and a profiler
    records, else the shared no-op context."""
    return _range(name) if _on else NO_SPAN


@contextlib.contextmanager
def collect_marks():
    """The marks `mark` records on this thread while inside, as a list of
    (name, event); `graphs.Graphed` opens it around a traced capture."""
    prev = getattr(_local, "marks", None)
    _local.marks = marks = []
    try:
        yield marks
    finally:
        _local.marks = prev


def mark(name: str):
    """A device mark at the end of stage `name`: a timing event recorded
    on the current stream, inside `collect_marks` only."""
    marks = getattr(_local, "marks", None)
    if marks is None:
        return
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    marks.append((name, ev))


def stage_ms(before, marks: List[Tuple[str, object]], after) -> Dict[str, float]:
    """ms of one replay: `graph` from `before` to `after`, each mark's
    stage from the event before it, and `outputs` from the last mark to
    `after` (the graph's output packing). The events must be complete."""
    out = {"graph": before.elapsed_time(after)}
    prev = before
    for name, ev in marks:
        out[name] = prev.elapsed_time(ev)
        prev = ev
    if marks:
        out["outputs"] = prev.elapsed_time(after)
    return out

"""The port's `jax.jit`: a step captured once per static key as a CUDA
graph, then replayed once a frame.

`uvio_tpu` compiles each step with `jax.jit` once per static signature
and dispatches one XLA program a frame (`pipeline.py:350-370`,
`frontend/tracker.py:72-90`). Run eagerly, the port's steps make
thousands of small launches a frame and the card idles while the host
makes them. `graphed(fn)` is the counterpart: a callable that on CUDA
inputs keeps one `torch.cuda.CUDAGraph` per static key and on CPU tensors
calls `fn` as it is, as the kernel wrappers take their plain versions on
the CPU.

The key is what `jax.jit` retraces on: the tree structure of the
arguments, the value of every argument that is not a tensor (the bools
of a `FramePlan`, a shape tuple, a dtype) and every tensor's shape,
dtype and device. For a new key the callable

  1. copies the inputs into static buffers: one flat buffer per dtype for
     the CUDA tensors, one device tensor for each host tensor;
  2. runs `fn` once eagerly on them on its own side stream, which warms up
     the solver libraries' handles and workspaces and the `lru_cache`d
     device tables (`math/chi2.py` `_device_table`); this run's result is
     the call's result;
  3. captures `fn` on that stream into a CUDA graph whose last nodes pack
     its outputs into one flat buffer per dtype.

A call with a known key copies the inputs in (one `torch.cat` per dtype
of its CUDA tensors, one `copy_` per host tensor, without waiting for the
device when the host tensor is pinned), replays the graph and returns
views of one clone of each output buffer. No result aliases memory that
a later call writes: a caller that keeps frame k's state sees it
unchanged after frame k+1.

A capture that fails raises; there is no eager fall-back on the card.
The capture runs in thread-local mode, so a thread that stages the next
inputs meanwhile (`pipeline.HostPipeline`) does not break it.

The hand kernels' wrappers count their launches when they run
(`launches.py` `launch_counts`). Under capture they run once and
launch nothing, so the counts a capture adds are taken back and each
replay adds them again (and to `replay_counts`): the counts stay the
launches the card made.

With tracing on (`tracing.enable()` before the callable is made) a
capture keeps the device marks its body records (`tracing.mark`) with its
graph, and each replay records a timing event before and after the
graph: `take_timed()` hands over (before, marks, after) of the replays
since it was last called, for `tracing.stage_ms` once the stream has
been waited for. Off, a replay records nothing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import tracing
from . import launches


# bytes between the starts of two tensors in a packed buffer: the
# alignment of a fresh allocation of PyTorch's CUDA caching allocator
ALIGN = 512


class Packer:
    """Tensors of fixed shapes and dtypes as views of one flat buffer per
    dtype: `pack` copies tensors in, `unpack` gives the views.

    Each view starts a multiple of `ALIGN` bytes into its buffer, which
    is itself a fresh allocation, so it is aligned as one: kernels choose their code by the alignment of their
    operands (cuBLAS among them), so a view at another offset can round
    otherwise than the eager step's freshly allocated tensor."""

    def __init__(self, tensors):
        self.shapes = [t.shape for t in tensors]
        self.groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            self.groups.setdefault(t.dtype, []).append(i)
        # per dtype: the padded length of each tensor's slot, in elements
        self.slots = {dt: [-(-self.shapes[i].numel() * dt.itemsize // ALIGN) * ALIGN // dt.itemsize
                           for i in idx] for dt, idx in self.groups.items()}
        self._pad = {}  # dtype -> a zero buffer the padding is cut from

    def pack(self, tensors, out=None):
        """{dtype: flat buffer} holding `tensors`, one `torch.cat` per
        dtype; into the buffers of `out` when given."""
        flats = {}
        for dt, idx in self.groups.items():
            parts = []
            for i, slot in zip(idx, self.slots[dt]):
                t = tensors[i].reshape(-1)
                parts.append(t)
                if slot > t.numel():
                    pad = self._pad.get(dt)
                    if pad is None or pad.device != t.device:
                        pad = self._pad[dt] = t.new_zeros(ALIGN // dt.itemsize)
                    parts.append(pad[: slot - t.numel()])
            flats[dt] = torch.cat(parts) if out is None else torch.cat(parts, out=out[dt])
        return flats

    def unpack(self, flats):
        out = [None] * len(self.shapes)
        for dt, idx in self.groups.items():
            parts = torch.split(flats[dt], self.slots[dt])
            for i, p in zip(idx, parts):
                out[i] = p[: self.shapes[i].numel()].view(self.shapes[i])
        return out


@dataclasses.dataclass
class _Entry:
    """One key's graph and its static buffers."""

    graph: Any
    dev_idx: List[int]  # which tensor inputs are on the card
    inputs: Packer  # those inputs
    in_flats: dict
    host: List[tuple]  # (index among the tensor inputs, static device tensor)
    outputs: Packer
    out_flats: dict
    out_leaves: list  # the output leaves, tensors as None
    out_spec: Any
    launches: Dict[str, int]  # hand-kernel launches recorded in the graph
    marks: list  # (name, event) of the device marks in the graph, traced
    warmup_ms: float
    capture_ms: float
    pool_bytes: int

    def load(self, tensors):
        """Copy one call's tensor inputs into the static buffers."""
        self.inputs.pack([tensors[i] for i in self.dev_idx], out=self.in_flats)
        for i, static in self.host:
            static.copy_(tensors[i], non_blocking=tensors[i].is_pinned())

    def results(self, flats):
        it = iter(self.outputs.unpack(flats))
        return tree_unflatten([next(it) if x is None else x for x in self.out_leaves], self.out_spec)


class Graphed:
    """`fn` as a callable that captures and replays CUDA graphs (module
    docstring). `eager` is `fn` itself, for comparisons; `entries` holds
    one record a captured key (its warm-up and capture ms, the bytes its
    graph's memory pool holds, the hand-kernel launches it replays).
    `last_capture_ms` is the warm-up + capture ms of the last call, 0 for
    a replay; `trace` is the tracing switch as it was when the callable
    was made (module docstring)."""

    # replays whose events are kept until taken: enough for one frame's
    # calls of any stage, and a bound for callables nobody takes from
    TIMED = 64

    def __init__(self, fn: Callable, name: str = None):
        self.eager = fn
        self.name = name or getattr(fn, "__qualname__", None) or repr(fn)
        self.entries: Dict[Any, _Entry] = {}
        self._stream = None
        self.trace = tracing.enabled()
        self.timed = collections.deque(maxlen=self.TIMED)
        self.last_capture_ms = 0.0

    def __call__(self, *args, **kwargs):
        leaves, spec = tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        device = next((t.device for t in tensors if t.device.type == "cuda"), None)
        if device is None:
            return self.eager(*args, **kwargs)
        key = (spec, tuple(None if isinstance(x, torch.Tensor) else x for x in leaves),
               tuple((t.shape, t.dtype, t.device) for t in tensors))
        entry = self.entries.get(key)
        if entry is None:
            return self._capture(key, leaves, spec, tensors, device)
        self.last_capture_ms = 0.0
        entry.load(tensors)
        if self.trace:
            before, after = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            before.record()
            entry.graph.replay()
            after.record()
            self.timed.append((before, entry.marks, after))
        else:
            entry.graph.replay()
        for k, n in entry.launches.items():
            launches.launch_counts[k] += n
            launches.replay_counts[k] += n
        return entry.results({dt: f.clone() for dt, f in entry.out_flats.items()})

    def take_timed(self) -> list:
        """(before, marks, after) of each replay since the last call,
        oldest first (traced only; module docstring)."""
        out = list(self.timed)
        self.timed.clear()
        return out

    def stats(self) -> dict:
        """Graphs captured, their warm-up and capture ms summed, the bytes
        their memory pools hold."""
        e = list(self.entries.values())
        return {"graphs": len(e), "warmup_ms": sum(x.warmup_ms for x in e),
                "capture_ms": sum(x.capture_ms for x in e), "pool_bytes": sum(x.pool_bytes for x in e)}

    def _capture(self, key, leaves, spec, tensors, device):
        with torch.cuda.device(device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            current = torch.cuda.current_stream(device)
            dev_idx = [i for i, t in enumerate(tensors) if t.device.type == "cuda"]
            host_idx = [i for i, t in enumerate(tensors) if t.device.type != "cuda"]
            inputs = Packer([tensors[i] for i in dev_idx])
            in_flats = inputs.pack([tensors[i] for i in dev_idx])
            host = [(i, tensors[i].to(device, non_blocking=tensors[i].is_pinned())) for i in host_idx]
            static = [None] * len(tensors)
            for i, t in zip(dev_idx, inputs.unpack(in_flats)):
                static[i] = t
            for i, t in host:
                static[i] = t
            it = iter(static)
            args, kwargs = tree_unflatten([next(it) if isinstance(x, torch.Tensor) else x for x in leaves], spec)

            # warm-up: the eager run on the side stream, packed there into
            # fresh buffers that become this call's result
            t0 = time.perf_counter()
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out_leaves, out_spec = tree_flatten(self.eager(*args, **kwargs))
                out_tensors = [x for x in out_leaves if isinstance(x, torch.Tensor)]
                outputs = Packer(out_tensors)
                first = outputs.pack(out_tensors)
            current.wait_stream(self._stream)
            for f in first.values():
                f.record_stream(current)
            warmup_ms = (time.perf_counter() - t0) * 1e3

            # Objects that die in reference cycles (a tracker or a manager
            # and the graphs they hold) are freed by the cyclic collector
            # at any allocation; freed during a capture, their graphs and
            # memory would invalidate it. Collect now, and not during it.
            gc.collect()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            counts = dict(launches.launch_counts)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            collecting = gc.isenabled()
            gc.disable()
            # traced: the marks the body records become event nodes of the graph
            marking = tracing.collect_marks() if self.trace else contextlib.nullcontext([])
            try:
                with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"), \
                        marking as marks:
                    cap_leaves, cap_spec = tree_flatten(self.eager(*args, **kwargs))
                    cap_tensors = [x for x in cap_leaves if isinstance(x, torch.Tensor)]
                    out_flats = outputs.pack(cap_tensors)
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture of {self.name} failed") from e
            finally:
                if collecting:
                    gc.enable()
                recorded = {k: launches.launch_counts[k] - counts[k] for k in counts}
                launches.launch_counts.update(counts)
            capture_ms = (time.perf_counter() - t0) * 1e3
            consts = [None if isinstance(x, torch.Tensor) else x for x in out_leaves]
            if cap_spec != out_spec or consts != [None if isinstance(x, torch.Tensor) else x for x in cap_leaves]:
                raise RuntimeError(f"{self.name}: the captured run returned another structure than "
                                   "the eager run of the same key")
            entry = _Entry(graph, dev_idx, inputs, in_flats, host, outputs, out_flats, consts, out_spec,
                           {k: n for k, n in recorded.items() if n}, marks, warmup_ms, capture_ms,
                           torch.cuda.memory_reserved(device) - reserved)
            self.entries[key] = entry
            self.last_capture_ms = warmup_ms + capture_ms
            return entry.results(first)


def graphed(fn: Callable, name: str = None) -> Graphed:
    """`fn` captured once per static key as a CUDA graph and replayed
    after (module docstring); on CPU tensors `fn` itself."""
    return Graphed(fn, name)

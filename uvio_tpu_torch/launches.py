"""What the wrappers of the hand-written CUDA kernels share: their launch
counts, the route from a tensor's device to a kernel or a plain version,
and the launch of a filter kernel.

A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises (`route`). Each kernel launch
adds one to `launch_counts[name]`, so a run can show that its main path
went through the kernels; inside a CUDA graph (`graphs.graphed`) the
launches recorded at the capture are added at each replay instead, and to
`replay_counts[name]` too: the launches that came from graph replays.

The kernels: the frontend's `fast9`, `lk_level` and `lk_track`
(`frontend/kernels.py`) and the filter's `uwb_update` (`update/uwb.py`),
`slam_init` (`update/slam.py` `slam_delayed_init`) and `msckf_update`
(`update/msckf.py`).

The filter kernels share one C signature, `uvio_<name>(ptrs, ints,
reals, stream)`, and a table of the state's mean blocks
(`filter.ekf.table_ints`, `csrc/mean_table.cuh`); their wrappers launch
through `check_table`, `check`, `launch` and `Launch`.
"""

from __future__ import annotations

import ctypes

import torch

from .filter.ekf import MASKS

launch_counts = {"fast9": 0, "lk_level": 0, "lk_track": 0, "uwb_update": 0, "slam_init": 0, "msckf_update": 0}
replay_counts = dict(launch_counts)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = replay_counts[k] = 0


def route(*tensors) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def check(fn: str, device, *specs):
    """Raises unless each (name, tensor, dtype, numel) of `specs` is so,
    contiguous on `device`; `fn` names the wrapper."""
    for name, t, dtype, numel in specs:
        if t.dtype != dtype:
            raise TypeError(f"{fn} {name}: expected {dtype}, got {t.dtype}")
        if t.numel() != numel:
            raise ValueError(f"{fn} {name}: expected {numel} values, got shape {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{fn} {name}: must be contiguous on {device}")


def check_table(fn: str, batch: int, cov, masks, fields, table: list):
    """Raises unless `cov` is float32 or float64 and the mean blocks
    `fields` and the `masks` (of `MASKS`) hold `batch` sequences of what
    `table` (`filter.ekf.table_ints`) says, in `cov`'s dtype and device."""
    dtype, device = cov.dtype, cov.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fn}: a float32 or float64 covariance, got {dtype}")
    if len(fields) != table[0] or len(masks) != len(MASKS):
        raise ValueError(f"{fn}: {len(fields)} mean blocks and {len(masks)} masks for a table "
                         f"of {table[0]} and {len(MASKS)}")
    for k, f in enumerate(fields):
        _, rows, width, _, _, mask = table[1 + 6 * k: 7 + 6 * k]
        check(fn, device, (f"block {k}", f, dtype, batch * rows * width))
        if mask >= 0:
            check(fn, device, (MASKS[mask], masks[mask], torch.bool, batch * rows))


def launch(name: str, batch: int, ptrs: list, fields: list, ints: list, reals: tuple) -> list:
    """Launches `uvio_<name>` on the current stream for `batch` sequences
    and counts it. The kernel reads the addresses of `ptrs` (the
    covariance first) and then of each mean block of `fields` and its
    output, which this allocates and returns; the ints are the precision,
    `batch`, then `ints`. Raises on a refused launch."""
    from . import _build

    cov, outs = ptrs[0], [torch.empty_like(f) for f in fields]
    ptrs = [*ptrs, *[t for pair in zip(fields, outs) for t in pair]]
    ints = [int(cov.dtype == torch.float64), batch, *ints]
    rc = getattr(_build.load(), f"uvio_{name}")(
        (ctypes.c_int64 * len(ptrs))(*[t.data_ptr() for t in ptrs]), (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_double * len(reals))(*reals), torch.cuda.current_stream(cov.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"uvio_{name} launch failed: cudaError {rc}")
    launch_counts[name] += 1
    return outs


class Launch(torch.autograd.Function):
    """`Launch.apply(launch, *tensors, ints, reals)` is `launch(1, *tensors,
    ints, reals)`, for its `vmap` rule: every tensor (or list of tensors)
    gets its batch axis first (broadcast where it has none) and one launch
    runs `info.batch_size` sequences. (A `torch.library` custom operator
    would do the same, but registering one imports torch's compiler stack,
    ~14 s on the card's installation.)"""

    @staticmethod
    def forward(launch, *args):
        return launch(1, *args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, launch, *args):
        B = info.batch_size

        def front(x, d):
            if isinstance(x, list):
                return [front(y, e) for y, e in zip(x, d)]
            return (x.movedim(d, 0) if d is not None else x.expand(B, *x.shape)).contiguous()

        out = launch(B, *[front(x, d) for x, d in zip(args[:-2], in_dims[1:-2])], *args[-2:])
        return out, (0,) * len(out)

"""The work of the port's two hand-written front-end kernels as functions
of a launch's shapes, and the share of a roofline a measured time reaches.

  fast9     (`csrc/fast9.cu`, one launch a frame): reads the float32 image
            and writes the float32 score map, H x W x 4 bytes each way; it
            compares 12 values a pixel (the compass pretest) and 96 for
            each pixel that passes (the whole ring, both sides, and the
            score). Its bound is its bytes.
  lk_track  (`csrc/lk_level.cu` `uvio_lk_track`, one launch a frame for
            every level): for each feature and level, 19 operations a
            template pixel (bilinear sample, gradients, the 2x2 system) and
            14 a window pixel in each iteration (sample, error, two
            products), over (2 half + 1)^2 pixels; `iters` iterations on
            level 0 and `coarse_iters` on each coarser one. Its bound is
            its operations.

The peaks are the H100 SXM's: 3.35 TB/s of HBM3 and 67 TFLOP/s of FP32
without tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fast9_bytes(height: int, width: int) -> int:
    return 2 * 4 * height * width


def fast9_flops(height: int, width: int, survivors: int) -> int:
    return 12 * height * width + 96 * survivors


def lk_track_flops(features: int, half: int = 7, levels: int = 4, iters: int = 10, coarse_iters: int = 6) -> int:
    window = (2 * half + 1) ** 2
    steps = iters + (levels - 1) * min(iters, coarse_iters)
    return features * window * (19 * levels + 14 * steps)


def bound_ms(flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The roofline's time for that work, ms: the slower of the two."""
    return 1e3 * max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline_pct(measured_ms: float, flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The share of its roofline a kernel that took `measured_ms` reached."""
    return 100.0 * bound_ms(flops, nbytes) / measured_ms

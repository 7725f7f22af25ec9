"""Native host code (C++ over a plain C ABI via ctypes).

The port's own copy of `uvio_tpu/native`: `select_imu.cpp` (the
per-frame IMU slice, interpolation and padding) and `csv_loader.cpp`
(one-pass numeric CSV/TUM text parsing). They are compiled with the
system's `g++` at first use into `_build/` beside this file; without a
toolchain every function returns None and the callers take their numpy
versions, exactly as in `uvio_tpu`: the native layer speeds up the host
data path and is never required. Host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(__file__)
_BUILD = os.path.join(_HERE, "_build")
_SO = os.path.join(_BUILD, "libuvio_torch_native.so")
_SRCS = [os.path.join(_HERE, "select_imu.cpp"), os.path.join(_HERE, "csv_loader.cpp")]

_lib = None


def _compile() -> bool:
    """Build the library; the output is written under a temporary name
    and renamed, so processes building at once never load a half-written
    file."""
    try:
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *_SRCS, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib():
    """ctypes handle to the native library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(os.path.getmtime(p) for p in _SRCS):
        if not _compile():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    fn = lib.uvio_select_imu_readings
    fn.restype = ctypes.c_int64
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    fn.argtypes = [dp, dp, dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_int64, dp, dp, dp]
    lib.uvio_csv_load.restype = ctypes.c_int64
    lib.uvio_csv_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.uvio_csv_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.uvio_csv_free.restype = None
    _lib = lib
    return _lib


def select_imu_readings(times, ws, accs, t0, t1, m_max):
    """Native IMU slice + interpolation + padding; None without the
    library. Same contract as `filter.propagator.select_imu_readings_np`,
    whose errors it raises: ValueError for a backwards request (code -1)
    and for a batch above `m_max` (code -2)."""
    lib = get_lib()
    if lib is None:
        return None
    times = np.ascontiguousarray(times, np.float64)
    ws = np.ascontiguousarray(ws, np.float64)
    accs = np.ascontiguousarray(accs, np.float64)
    if times.ndim != 1 or ws.shape != (len(times), 3) or accs.shape != (len(times), 3):
        raise ValueError(f"IMU arrays of shapes {times.shape}, {ws.shape}, {accs.shape}; want (n,), (n,3), (n,3)")
    out_t = np.empty(m_max, np.float64)
    out_w = np.empty((m_max, 3), np.float64)
    out_a = np.empty((m_max, 3), np.float64)
    rc = lib.uvio_select_imu_readings(times, ws, accs, len(times), float(t0), float(t1), m_max, out_t, out_w, out_a)
    if rc == -1:
        raise ValueError("backwards propagation request")
    if rc == -2:
        raise ValueError(f"IMU batch exceeds max_imu_batch={m_max}; raise the layout limit")
    return out_t, out_w, out_a


def load_csv(path: str):
    """Native one-pass CSV/TUM-text parse -> (rows, cols) float64 array;
    None without the library (callers fall back to the Python csv
    reader). Skips '#', header and blank lines; ',' or whitespace
    separated. FileNotFoundError for a missing file, ValueError for
    ragged rows."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.uvio_csv_load(path.encode(), ctypes.byref(out), ctypes.byref(rows), ctypes.byref(cols))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"ragged csv rows in {path}")
    if rows.value * cols.value == 0:
        lib.uvio_csv_free(out)
        return np.zeros((0, max(cols.value, 0)))
    arr = np.ctypeslib.as_array(out, shape=(rows.value, cols.value)).copy()
    lib.uvio_csv_free(out)
    return arr

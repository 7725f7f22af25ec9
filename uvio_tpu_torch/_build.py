"""Build and load the port's CUDA kernels.

`csrc/*.cu` are compiled by `nvcc` for `sm_90a` into one shared library
with a plain C interface, `build/uvio_tpu_torch/libuvio_kernels.so`
under the repository root, at first use. The library is rebuilt when
the sources' hash changes and loaded with `ctypes`; no PyTorch headers
are involved, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "uvio_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libuvio_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None


def sources():
    return sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cu")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the kernels if the library is missing or stale. Returns
    the compiler's resource report (`-Xptxas -v`), empty when the
    library was already up to date."""
    srcs = sources()
    digest = _digest(srcs)
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes
    set: pointers and the stream as c_void_p, sizes as c_int."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.uvio_fast9.argtypes = [P, P, I, I, Fl, P]
        lib.uvio_fast9.restype = I
        lib.uvio_lk_level.argtypes = [P, P, I, I, P, P, P, P, P, I, I, I, Fl, P]
        lib.uvio_lk_level.restype = I
        _lib = lib
    return _lib

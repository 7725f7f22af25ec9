"""Build and load the port's CUDA kernels.

`csrc/*.cu` are compiled by `nvcc` for `sm_90a`, one process per source
and all at once, and linked into one shared library with a plain C
interface, `build/uvio_tpu_torch/libuvio_kernels.so` under the
repository root, at first use. The library is rebuilt when the hash of
the sources and the headers they include (`csrc/*.cuh`) changes, and
loaded with `ctypes`; no PyTorch headers are involved, so a build takes
seconds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "uvio_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libuvio_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest() -> str:
    """The library's stamp: a hash of the flags, the sources and the
    headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the kernels if the library is missing or stale. Returns
    the compiler's resource report (`-Xptxas -v`), empty when the
    library was already up to date."""
    srcs = sources()
    digest = _digest()
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{LIB_PATH}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)
    ]
    report, failed = "", False
    for proc in procs:
        report += proc.communicate()[0]
        failed |= proc.returncode != 0
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", tag + ".tmp", *objs], capture_output=True,
                              text=True)
        report += link.stdout + link.stderr
        failed = link.returncode != 0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{report}")
    os.replace(tag + ".tmp", LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return report


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argtypes of the entry points `lib` has: pointers and the
    stream as c_void_p, sizes as c_int."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the filter kernels (`launches.launch`): host arrays of pointers, ints
    # and reals laid out as their wrappers say, and the stream
    filter_entry = [P, P, P, P]
    signatures = {
        "uvio_fast9": [P, P, I, I, Fl, P],
        "uvio_lk_level": [P, P, I, I, P, P, P, P, P, I, I, I, Fl, P],
        # the pyramids and their sizes are host arrays of `levels` entries
        "uvio_lk_track": [P, P, P, P, I, P, P, P, P, I, I, I, I, Fl, P],
        "uvio_empty_launch": [I, I, I, P],
        "uvio_uwb_update": filter_entry,
        "uvio_slam_init": filter_entry,
        "uvio_msckf_update": filter_entry,
        "uvio_msckf_work_bytes": [I, I, I, I, I],
        "uvio_uwb_shared_memory": [P, P],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
    return lib


def load() -> ctypes.CDLL:
    """The package's kernel library (built first if needed), bound."""
    global _lib
    if _lib is None:
        build()
        _lib = bind(ctypes.CDLL(LIB_PATH))
    return _lib

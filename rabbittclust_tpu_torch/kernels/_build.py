"""Build the port's CUDA sources into a plain-C shared library, at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles ``csrc/*.cu`` (no
PyTorch headers) into ``build/librtc_kernels_<hash>.so``, keyed by a hash
of the sources and flags, and the library is loaded with ``ctypes``.
Nothing runs at import time.  A missing ``nvcc`` or a failed build raises
with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                       "port's CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librtc_kernels_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the sources unless the keyed library exists.  Returns
    ``{"path", "seconds", "log"}``: build seconds (0.0 when it was already
    built) and the compiler's ``-Xptxas -v`` report (registers, shared
    memory, spills per kernel)."""
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return {"path": path, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    log = proc.stderr + proc.stdout
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)  # atomic: concurrent builders race harmlessly
    return {"path": path, "seconds": seconds, "log": log}


@lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """The built library with its entry points' signatures declared."""
    lib = ctypes.CDLL(build()["path"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rtc_pair_counts_tiles.restype = ci
    lib.rtc_pair_counts_tiles.argtypes = [vp, vp, vp, vp, vp, vp,
                                          ci, ci, ci, ci, ci, vp]
    lib.rtc_pair_common.restype = ci
    lib.rtc_pair_common.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    return lib

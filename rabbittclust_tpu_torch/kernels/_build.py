"""Build the port's compiled sources into plain-C shared libraries, at
first use.

Two libraries, each keyed by a hash of its sources and flags
(``build/<stem>_<hash>.so``) and loaded with ``ctypes``:

- the CUDA kernels (``build``, ``load_kernels``): ``nvcc -gencode
  arch=compute_90a,code=sm_90a`` compiles each ``csrc/*.cu`` (no PyTorch
  headers) into an object file, one process per source, all started
  together; one more ``nvcc`` links them into ``librtc_kernels_<hash>.so``;
- the host code (``build_host``, ``load_host``): ``g++ -O3 -fopenmp``
  compiles ``hostsrc/*.cpp`` into ``librtc_host_<hash>.so``, without
  ``nvcc``.

Nothing runs at import time.  A missing compiler or a failed build raises
with the compiler's output; there is no fallback.  Processes that start
together (the ranks of a multi-process run) build a library one at a time
under a file lock, and those that waited load the library the first one
built; a library is built once a checkout.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
HOSTSRC_DIR = os.path.join(_PKG_DIR, "hostsrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math: K4's stats mode computes the float32 Mash distance
# with the full-precision logf and IEEE-rounded division that the plain
# version and the JAX program use (-prec-div, -prec-sqrt and -ftz=false are
# nvcc's defaults without it).
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# No -march=native: a checkout's build must load on any x86-64 host.
GXX_FLAGS = ["-std=c++17", "-O3", "-fopenmp", "-shared", "-fPIC"]


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _host_sources():
    return sorted(glob.glob(os.path.join(HOSTSRC_DIR, "*.cpp")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                       "port's CUDA kernels cannot be built")


def _keyed_path(stem: str, flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    return _keyed_path("librtc_kernels", NVCC_FLAGS, _sources())


def host_library_path() -> str:
    return _keyed_path("librtc_host", GXX_FLAGS, _host_sources())


def _build_once(path: str, compile_fn) -> dict:
    """``compile_fn(path)`` unless the keyed library exists, under the
    build directory's file lock."""
    if os.path.exists(path):
        return _built(path)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it meanwhile
            return _built(path)
        return compile_fn(path)


def build() -> dict:
    """Compile the CUDA sources unless the keyed library exists.  Returns
    ``{"path", "seconds", "log"}``: build seconds (0.0 when it was already
    built) and the compiler's ``-Xptxas -v`` report (registers, shared
    memory, spills per kernel)."""
    return _build_once(library_path(), _compile)


def build_host() -> dict:
    """Compile the host sources with g++ unless the keyed library exists;
    returns as ``build`` does."""
    return _build_once(host_library_path(), _compile_host)


def _built(path: str) -> dict:
    log_path = path[:-3] + ".log"
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    return {"path": path, "seconds": 0.0, "log": log}


def _compile(path: str) -> dict:
    log_path = path[:-3] + ".log"
    cu = [s for s in _sources() if s.endswith(".cu")]
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in cu]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
                         for src, obj in zip(cu, objs))]
    logs = [proc.communicate()[0] for _, proc in procs]  # wait for all
    for (cmd, proc), out in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    log = "".join(logs) + proc.stderr + proc.stdout
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)  # atomic: no reader sees a half-written library
    return {"path": path, "seconds": seconds, "log": log}


def _compile_host(path: str) -> dict:
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, *_host_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    log = proc.stderr + proc.stdout
    with open(path[:-3] + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": log}


@lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """The built library with its entry points' signatures declared."""
    lib = ctypes.CDLL(build()["path"])
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    cf = ctypes.c_float
    lib.rtc_pair_tiles.restype = ci
    lib.rtc_pair_tiles.argtypes = [vp] * 18 + [ci] * 11 + [cf, cf, vp]
    lib.rtc_pair_common.restype = ci
    lib.rtc_pair_common.argtypes = [vp] * 12 + [ci] * 3 + [vp]
    lib.rtc_div_rn_normal.restype = ci
    lib.rtc_div_rn_normal.argtypes = [vp, vp, vp, ci, vp]
    lib.rtc_filter_mask.restype = ci
    lib.rtc_filter_mask.argtypes = [vp, vp, ci] + [vp] * 9 + [ci] * 4 + [
        cf, cf, cf, ci, cf, ci, ci, ci, vp, vp, vp]
    lib.rtc_greedy_filter.restype = ci
    lib.rtc_greedy_filter.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci,
                                      cf, cf, cf, cf, ci, ci, vp, vp, ci,
                                      cu, ci, vp, vp]
    lib.rtc_ring_step.restype = ci
    lib.rtc_ring_step.argtypes = [vp, vp, ci] + [vp] * 4 + [ci] * 3 + [
        cf, cf, cf, ci, ci, ci, vp, vp, vp]
    lib.rtc_wgmma_b1_peak.restype = ci
    lib.rtc_wgmma_b1_peak.argtypes = [ci, ci, ci, vp, vp]
    lib.rtc_mma_b1_peak.restype = ci
    lib.rtc_mma_b1_peak.argtypes = [ci, ci, ci, ci, vp, vp]
    lib.rtc_lp_round.restype = ci
    lib.rtc_lp_round.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, ci, vp,
                                 vp]
    lib.rtc_lp_round_compact.restype = ci
    lib.rtc_lp_round_compact.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci,
                                         ci, vp, ci, ci, ci, vp, vp]
    lib.rtc_lp_compact.restype = ci
    lib.rtc_lp_compact.argtypes = [vp, ci, ci, ci, ci, vp, vp]
    lib.rtc_mask_compact.restype = ci
    lib.rtc_mask_compact.argtypes = [vp] * 4 + [ci] * 4 + [vp, vp] + [
        ci] * 3 + [vp, ci, cu, vp]
    lib.rtc_mask_compact_rows.restype = ci
    lib.rtc_mask_compact_rows.argtypes = [vp, ci, ci, ci, vp, vp, ci, cu, ci,
                                          vp, vp]
    u64 = ctypes.c_uint64
    lib.rtc_kssd_sketch.restype = ci
    lib.rtc_kssd_sketch.argtypes = [vp, ci, ci, vp, ci, vp, u64, u64, u64,
                                    u64, ci, ci, ci, vp, vp, vp, vp, vp]
    lib.rtc_kssd_keep_bitmap.restype = ci
    lib.rtc_kssd_keep_bitmap.argtypes = [vp, ci, ci, vp, vp]
    lib.rtc_tuple_match.restype = ci
    lib.rtc_tuple_match.argtypes = [vp, ci, ci, ci, vp, vp, vp, ci, vp, vp]
    lib.rtc_tuple_ids.restype = ci
    lib.rtc_tuple_ids.argtypes = [vp, ci, ci, ci, vp, vp, vp]
    return lib


@lru_cache(maxsize=1)
def load_host() -> ctypes.CDLL:
    """The built host library with its entry points' signatures declared."""
    lib = ctypes.CDLL(build_host()["path"])
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rtc_kruskal.restype = i64
    lib.rtc_kruskal.argtypes = [vp, vp, vp, i64, i64, ctypes.c_int, vp]
    return lib

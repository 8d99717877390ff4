"""ctypes bindings for the native host library ``native/librtc_native.so``
(built from ``native/rtc_native.cpp`` at the repository root, beside both
packages).

The port uses its KSSD and MinHash sketchers, its MST and greedy engines,
its Louvain/Leiden loops, its size sort and pair counts, the CSR flatten
and exact-count kernels, the signature pack, the mask decoder and the
verify merge.  If the library is missing, or older than its source, it is
built with g++ here; if it can be neither built nor loaded, ``load_native``
raises: the port has no NumPy fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "librtc_native.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "rtc_native.cpp")

_c_u64p = ctypes.POINTER(ctypes.c_uint64)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_u32p = ctypes.POINTER(ctypes.c_uint32)


# Source: rabbittclust_tpu/utils/native.py::_try_build
def _try_build() -> bool:
    if not os.path.exists(_SRC_PATH):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-o", _LIB_PATH, _SRC_PATH, "-lz"],
            check=True, capture_output=True, timeout=300,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


# Source: rabbittclust_tpu/utils/native.py::load_native (the signatures the
# port calls)
@lru_cache(maxsize=1)
def load_native():
    """Load (building if needed) the native library; raises if it can be
    neither built nor loaded.

    A stale .so (older than rtc_native.cpp, e.g. after a git pull) is
    rebuilt automatically — new ctypes signatures below would otherwise
    fail on missing symbols."""
    stale = (os.path.exists(_LIB_PATH) and os.path.exists(_SRC_PATH)
             and os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH))
    if stale:
        _try_build()  # failure falls through to loading the stale copy
    if not os.path.exists(_LIB_PATH) and not _try_build():
        raise RuntimeError(f"{_LIB_PATH} is missing and g++ could not build "
                           f"it from {_SRC_PATH}")
    lib = ctypes.CDLL(_LIB_PATH)
    lib.rtc_generate_shuffle_dim.argtypes = [ctypes.c_int, _c_i32p]
    lib.rtc_sketch_files.restype = ctypes.c_void_p
    lib.rtc_sketch_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _c_i32p, ctypes.c_int,
    ]
    lib.rtc_sketch_sequences.restype = ctypes.c_void_p
    lib.rtc_sketch_sequences.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _c_i32p, ctypes.c_int,
    ]
    lib.rtc_sketch_files_minhash_contain.restype = ctypes.c_void_p
    lib.rtc_sketch_files_minhash_contain.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.rtc_result_count.restype = ctypes.c_int64
    lib.rtc_result_count.argtypes = [ctypes.c_void_p]
    lib.rtc_result_free.argtypes = [ctypes.c_void_p]
    lib.rtc_result_meta.argtypes = [
        ctypes.c_void_p, _c_i32p, _c_i64p, _c_i64p, _c_i64p, _c_i64p,
        _c_i64p]
    lib.rtc_result_strings_len.restype = ctypes.c_int64
    lib.rtc_result_strings_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtc_result_strings.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.rtc_result_hashes_all.argtypes = [ctypes.c_void_p, _c_u64p]
    lib.rtc_stdsort_size_desc.argtypes = [_c_i64p, ctypes.c_int64, _c_i32p]
    # Source: rabbittclust_tpu/cluster/greedy.py::_greedy_native (argtypes)
    for fn in ("rtc_greedy_u32", "rtc_greedy_u64"):
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p]
    lib.rtc_greedy_minhash.argtypes = [
        _c_u64p, _c_i64p, ctypes.c_int64, _c_i64p, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, _c_i32p]
    # Source: rabbittclust_tpu/cluster/mst.py::native_pair_counts (argtypes)
    for fn in ("rtc_pairs_u32", "rtc_pairs_u64"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
    lib.rtc_pairs_count.restype = ctypes.c_int64
    lib.rtc_pairs_count.argtypes = [ctypes.c_void_p]
    lib.rtc_pairs_data.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.rtc_pairs_free.argtypes = [ctypes.c_void_p]
    for fn in ("rtc_mst_u32", "rtc_mst_u64"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, _c_i64p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int]
    lib.rtc_mst_edge_count.restype = ctypes.c_int64
    lib.rtc_mst_edge_count.argtypes = [ctypes.c_void_p]
    lib.rtc_mst_edges.argtypes = [ctypes.c_void_p, _c_i32p, _c_i32p,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.rtc_mst_has_dense.restype = ctypes.c_int32
    lib.rtc_mst_has_dense.argtypes = [ctypes.c_void_p]
    lib.rtc_mst_dense.argtypes = [ctypes.c_void_p, _c_i32p, _c_u64p]
    lib.rtc_mst_free.argtypes = [ctypes.c_void_p]
    for fn in ("rtc_count_common_u32", "rtc_count_common_u64"):
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.rtc_sort_u64.argtypes = [_c_u64p, ctypes.c_int64, ctypes.c_int]
    lib.rtc_pack_postings_u32.argtypes = [_c_u32p, _c_i64p, ctypes.c_int64,
                                          _c_u64p, ctypes.c_int]
    lib.rtc_unpack_postings_u32.argtypes = [_c_u64p, ctypes.c_int64,
                                            _c_u32p, _c_u32p, ctypes.c_int]
    # Source: rabbittclust_tpu/utils/native.py::load_native (the community
    # detection hot loops of cluster/leiden.py)
    _c_f64p = ctypes.POINTER(ctypes.c_double)
    lib.rtc_louvain_one_level.restype = ctypes.c_int64
    lib.rtc_louvain_one_level.argtypes = [
        ctypes.c_int64, _c_i64p, _c_i64p, _c_f64p, _c_f64p,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_int64,
        _c_i64p]
    lib.rtc_leiden_refine_moves.argtypes = [
        ctypes.c_int64, _c_i64p, _c_i64p, _c_f64p, _c_f64p,
        ctypes.c_double, _c_i64p, ctypes.c_double, _c_f64p, _c_f64p,
        ctypes.c_void_p, _c_i64p]
    lib.rtc_csr_build.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _c_i64p, _c_i64p, _c_f64p,
        _c_i64p, _c_i64p, _c_f64p, _c_f64p]
    for fn in ("rtc_intra_mst_u32", "rtc_intra_mst_u64"):
        getattr(lib, fn).restype = ctypes.c_void_p
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, _c_i64p, ctypes.c_int64, _c_i32p,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, _c_i32p,
            ctypes.c_int]
    return lib


# Source: rabbittclust_tpu/utils/native.py::flatten_csr
def flatten_csr(hashes, use64: bool):
    """(flat, offs) CSR flatten of per-genome hash arrays — parallel
    native gather (rtc_flatten) when the arrays are uniform/contiguous,
    np.concatenate otherwise."""
    dt = np.uint64 if use64 else np.uint32
    n = len(hashes)
    offs = np.zeros(n + 1, dtype=np.int64)
    if not n:
        return np.empty(0, dtype=dt), offs
    np.cumsum([len(h) for h in hashes], out=offs[1:])
    if all(h.dtype == dt and h.flags.c_contiguous for h in hashes):
        lib = load_native()
        flat = np.empty(int(offs[-1]), dtype=dt)
        ptrs = np.fromiter((h.ctypes.data for h in hashes),
                           dtype=np.uint64, count=n)
        lib.rtc_flatten.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int]
        lib.rtc_flatten(ptrs.ctypes.data, offs.ctypes.data, n,
                        dt().itemsize, flat.ctypes.data,
                        os.cpu_count() or 1)
        return flat, offs
    return np.concatenate(hashes).astype(dt), offs


def _mst_handle_edges(lib, h):
    m = int(lib.rtc_mst_edge_count(h))
    ei = np.empty(m, dtype=np.int32)
    ej = np.empty(m, dtype=np.int32)
    ed = np.empty(m, dtype=np.float64)
    if m:
        lib.rtc_mst_edges(h, ei.ctypes.data_as(_c_i32p),
                          ej.ctypes.data_as(_c_i32p),
                          ed.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return ei.astype(np.int64), ej.astype(np.int64), ed


# Source: rabbittclust_tpu/utils/native.py::native_mst
def native_mst(hashes, threshold: float, kmer_size: int,
               is_containment: bool, start_index: int, with_dense: bool,
               threads: int):
    """Run the native MST engine over CSR sketches; returns
    (edges(i,j,d), dense|None, ani|None)."""
    lib = load_native()
    n = len(hashes)
    use64 = n > 0 and hashes[0].dtype == np.uint64
    flat, offs = flatten_csr(hashes, use64)
    fn = lib.rtc_mst_u64 if use64 else lib.rtc_mst_u32
    h = fn(flat.ctypes.data, offs.ctypes.data_as(_c_i64p), n,
           float(threshold), int(kmer_size), int(is_containment),
           int(start_index), int(with_dense), int(threads))
    try:
        edges = _mst_handle_edges(lib, h)
        dense = ani = None
        if with_dense and lib.rtc_mst_has_dense(h):
            dense = np.empty(100 * n, dtype=np.int32)
            ani = np.empty(101, dtype=np.uint64)
            lib.rtc_mst_dense(h, dense.ctypes.data_as(_c_i32p),
                              ani.ctypes.data_as(_c_u64p))
            dense = dense.reshape(100, n).astype(np.int64)
            ani = ani.astype(np.int64)
        return edges, dense, ani
    finally:
        lib.rtc_mst_free(h)


# Source: rabbittclust_tpu/utils/native.py::native_intra_mst
def native_intra_mst(hashes, labels, threshold: float, kmer_size: int,
                     is_containment: bool, abort_on_cross: bool = False):
    """Intra-partition -t 1 cadence replay (rtc_intra_mst_*): the MST of
    each cluster's internal candidate edges, in the reference's final edge
    order — cut at the threshold this yields the byte-identical
    generateClusterWithBfs member order for a known-exact partition.
    Returns (edges (i, j, d), has_cross) — ``has_cross`` False certifies
    the replay byte-identical to the global -t 1 engine (no hash shared
    across clusters).  ``abort_on_cross`` returns empty edges immediately
    when the certificate fails (the caller reruns the full global engine)."""
    lib = load_native()
    n = len(hashes)
    use64 = n > 0 and hashes[0].dtype == np.uint64
    flat, offs = flatten_csr(hashes, use64)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    has_cross = np.zeros(1, dtype=np.int32)
    fn = lib.rtc_intra_mst_u64 if use64 else lib.rtc_intra_mst_u32
    h = fn(flat.ctypes.data, offs.ctypes.data_as(_c_i64p), n,
           labels.ctypes.data_as(_c_i32p), float(threshold),
           int(kmer_size), int(is_containment),
           has_cross.ctypes.data_as(_c_i32p), int(abort_on_cross))
    try:
        return _mst_handle_edges(lib, h), bool(has_cross[0])
    finally:
        lib.rtc_mst_free(h)


# Source: rabbittclust_tpu/utils/native.py::make_file_array
def make_file_array(files):
    arr = (ctypes.c_char_p * len(files))()
    keep = [os.fsencode(f) for f in files]
    for i, b in enumerate(keep):
        arr[i] = b
    return arr, keep


# Source: rabbittclust_tpu/utils/native.py::SketchResultHandle (bulk
# extraction only)
class SketchResultHandle:
    """RAII wrapper over a native SketchResult*."""

    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __len__(self):
        return int(self._lib.rtc_result_count(self._ptr))

    def bulk(self):
        """One-call-per-field extraction of the whole result set.  Returns
        a dict of arrays/lists: ok, seq0_len, total_len, num_seqs,
        param_size, plus the flat uint64 hashes with their CSR offsets and
        decoded name/comment/file lists."""
        lib, p = self._lib, self._ptr
        n = len(self)
        ok = np.empty(n, dtype=np.int32)
        seq0 = np.empty(n, dtype=np.int64)
        total = np.empty(n, dtype=np.int64)
        nseq = np.empty(n, dtype=np.int64)
        psize = np.empty(n, dtype=np.int64)
        ssize = np.empty(n, dtype=np.int64)
        lib.rtc_result_meta(p, ok.ctypes.data_as(_c_i32p),
                            seq0.ctypes.data_as(_c_i64p),
                            total.ctypes.data_as(_c_i64p),
                            nseq.ctypes.data_as(_c_i64p),
                            psize.ctypes.data_as(_c_i64p),
                            ssize.ctypes.data_as(_c_i64p))
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ssize, out=offs[1:])
        flat = np.empty(int(offs[-1]), dtype=np.uint64)
        if len(flat):
            lib.rtc_result_hashes_all(p, flat.ctypes.data_as(_c_u64p))
        strs = []
        for field in range(3):
            ln = int(lib.rtc_result_strings_len(p, field))
            buf = np.empty(ln, dtype=np.uint8)
            if ln:
                lib.rtc_result_strings(p, field, buf.ctypes.data)
            parts = buf.tobytes().split(b"\0")[:n]
            strs.append(parts)
        return {
            "ok": ok, "seq0_len": seq0, "total_len": total,
            "num_seqs": nseq, "param_size": psize, "offs": offs,
            "flat_hashes": flat,
            "names": [b.decode("utf-8", "replace") for b in strs[0]],
            "comments": [b.decode("utf-8", "replace") for b in strs[1]],
            "files": [os.fsdecode(b) for b in strs[2]],
        }

    def __del__(self):
        try:
            if self._ptr:
                self._lib.rtc_result_free(self._ptr)
                self._ptr = None
        except Exception:
            pass

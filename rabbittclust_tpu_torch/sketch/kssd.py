"""KSSD sketching — the ``--fast`` sketch path, bit-identical to reference.

The KSSD sketch of a genome is the deduplicated, sorted set of compressed
canonical k-mers whose "dimension id" (the middle ``half_subk`` bases) falls
into the kept fraction of a deterministically shuffled dimension space
(1/4^drlevel of k-mer space; 1/4096 at drlevel=3).

Math replicated exactly from reference src/SketchInfo.cpp:
  * parameter derivation / bit masks:        SketchInfo.cpp:1019-1065
  * shuffle table (glibc rand seeds 23,
    348842630):                              SketchInfo.cpp:60-102
  * rolling 2-bit canonical scan + filter:   SketchInfo.cpp:1120-1165

Sketching runs in the native C++ library (``native/rtc_native.cpp`` via
ctypes); this module derives the parameters and drives it.  ``BASE_MAP``
encodes bases for the device sketcher (``ops/sketch_device.py``), and
``kssd_kmer_hashes_numpy`` is the NumPy statement of the sketch its tests
hold it to.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..utils import native as native_mod
from .base import SketchSet

# the shuffle-table cache at the repository root, shared with the JAX package
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache")

# Source: rabbittclust_tpu/sketch/kssd.py::BASE_MAP
# Base encoding: A/a=0 C/c=1 G/g=2 T/t=3, everything else -1
BASE_MAP = np.full(256, -1, dtype=np.int8)
for i, b in enumerate("ACGT"):
    BASE_MAP[ord(b)] = i
    BASE_MAP[ord(b.lower())] = i


# Source: rabbittclust_tpu/sketch/kssd.py::KssdParams
@dataclass(frozen=True)
class KssdParams:
    """Derived KSSD parameters (reference KssdParameters, SketchInfo.h:50-56)."""

    half_k: int
    half_subk: int
    drlevel: int

    @classmethod
    def from_kmer_size(cls, kmer_size: int, drlevel: int) -> "KssdParams":
        half_k = (kmer_size + 1) // 2
        half_subk = 6 if 6 - drlevel >= 2 else drlevel + 2
        return cls(half_k=half_k, half_subk=half_subk, drlevel=drlevel)

    @property
    def kmer_size(self) -> int:
        return 2 * self.half_k

    @property
    def use64(self) -> bool:
        return (self.half_k - self.drlevel) > 8

    @property
    def dim_end(self) -> int:
        return 1 << (4 * (self.half_subk - self.drlevel))

    @property
    def id(self) -> int:
        return (self.half_k << 8) + (self.half_subk << 4) + self.drlevel

    # --- bit masks (names follow the reference for auditability) ---
    @property
    def tupmask(self) -> int:
        return (1 << (4 * self.half_k)) - 1

    @property
    def domask(self) -> int:
        hol = self.half_k - self.half_subk
        return ((self.tupmask >> (4 * hol)) << (2 * hol)) & self.tupmask

    @property
    def undomask0(self) -> int:
        u = (self.tupmask ^ self.domask) & self.tupmask
        u1 = u & (self.tupmask >> ((self.half_k + self.half_subk) * 2))
        return u ^ u1

    @property
    def undomask1(self) -> int:
        u = (self.tupmask ^ self.domask) & self.tupmask
        return u & (self.tupmask >> ((self.half_k + self.half_subk) * 2))


# Source: rabbittclust_tpu/sketch/kssd.py::get_shuffle_table
@lru_cache(maxsize=4)
def get_shuffle_table(half_subk: int) -> np.ndarray:
    """The shuffled dimension table: int32 array of size 16^half_subk.

    Entry t is the shuffle rank of dimension t; a k-mer is kept iff
    table[dim_id] < dim_end.  Cached on disk (64 MB at half_subk=6).
    """
    dim_size = 1 << (4 * half_subk)
    cache_file = os.path.join(_CACHE_DIR, f"shuffle_dim_hs{half_subk}.npy")
    if os.path.exists(cache_file):
        arr = np.load(cache_file)
        if arr.shape == (dim_size,) and arr.dtype == np.int32:
            return arr
    arr = np.empty(dim_size, dtype=np.int32)
    native_mod.load_native().rtc_generate_shuffle_dim(
        half_subk, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        np.save(cache_file, arr)
    except OSError:
        pass
    return arr


# Source: rabbittclust_tpu/sketch/kssd.py::kssd_kmer_hashes_numpy
def kssd_kmer_hashes_numpy(seq: bytes, p: KssdParams,
                           shuffled_dim: np.ndarray) -> np.ndarray:
    """All kept (non-deduplicated) KSSD hashes of one sequence, as uint64."""
    k = p.kmer_size
    codes = BASE_MAP[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.uint64)
    from numpy.lib.stride_tricks import sliding_window_view
    win = sliding_window_view(codes, k)                       # (n-k+1, k)
    valid = (win >= 0).all(axis=1)
    if not valid.any():
        return np.empty(0, dtype=np.uint64)
    w = win[valid].astype(np.uint64)
    sh_fwd = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    sh_rev = (2 * np.arange(k)).astype(np.uint64)
    tup = (w << sh_fwd).sum(axis=1)
    rvs = ((w ^ np.uint64(3)) << sh_rev).sum(axis=1)
    uni = np.minimum(tup, rvs)
    hol2 = np.uint64(2 * (p.half_k - p.half_subk))
    dim_id = ((uni & np.uint64(p.domask)) >> hol2).astype(np.int64)
    pf = shuffled_dim[dim_id]
    keep = (pf >= 0) & (pf < p.dim_end)
    if not keep.any():
        return np.empty(0, dtype=np.uint64)
    uni = uni[keep]
    pf = pf[keep].astype(np.uint64)
    shift1 = np.uint64(2 * p.kmer_size - 4 * (p.half_k - p.half_subk))
    dr = ((((uni & np.uint64(p.undomask0))
            | ((uni & np.uint64(p.undomask1)) << shift1))
           >> np.uint64(4 * p.drlevel)) | pf)
    return dr


# Source: rabbittclust_tpu/sketch/kssd.py::_finalize_dtype
def _finalize_dtype(h: np.ndarray, use64: bool) -> np.ndarray:
    return h if use64 else h.astype(np.uint32)


# Source: rabbittclust_tpu/sketch/kssd.py::sketch_files_kssd
def sketch_files_kssd(files, min_len: int, kmer_size: int, drlevel: int,
                      threads: int = 0) -> "tuple[SketchSet, KssdParams]":
    """Sketch a list of genome FASTA(.gz) files (one genome per file).

    Genomes shorter than ``min_len`` are dropped (reference
    SketchInfo.cpp:1210).  IDs are assigned in input-list order among kept
    genomes (deterministic; the reference uses nondeterministic completion
    order when lengths tie — acknowledged in its version_history/history.md).
    """
    p = KssdParams.from_kmer_size(kmer_size, drlevel)
    table = get_shuffle_table(p.half_subk)
    threads = threads or (os.cpu_count() or 1)
    ss = SketchSet("kssd", p, True, p.use64)
    lib = native_mod.load_native()
    arr, _keep = native_mod.make_file_array(files)
    ptr = lib.rtc_sketch_files(
        arr, len(files), int(min_len), 0, p.half_k, p.half_subk,
        p.drlevel, table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads)
    res = native_mod.SketchResultHandle(lib, ptr)
    b = res.bulk()
    bad = np.flatnonzero(b["ok"] == 0)
    if len(bad):
        raise FileNotFoundError(
            f"cannot open the genome file: {files[int(bad[0])]}")
    flat = _finalize_dtype(b["flat_hashes"], p.use64)
    offs = b["offs"]
    keep = np.flatnonzero(b["total_len"] >= min_len)
    ss.file_names = [b["files"][i] for i in keep]
    ss.names = [b["names"][i] for i in keep]
    ss.comments = [b["comments"][i] for i in keep]
    ss.seq0_lens = b["seq0_len"][keep].tolist()
    ss.total_lens = b["total_len"][keep].tolist()
    ss.num_seqs = b["num_seqs"][keep].tolist()
    ss.param_sizes = [0] * len(keep)
    ss.hashes = [flat[offs[i]:offs[i + 1]] for i in keep.tolist()]
    return ss, p


# Source: rabbittclust_tpu/sketch/kssd.py::sketch_sequences_kssd
def sketch_sequences_kssd(input_file: str, min_len: int, kmer_size: int,
                          drlevel: int, threads: int = 0
                          ) -> "tuple[SketchSet, KssdParams]":
    """Sketch each sequence of a single FASTA file as its own genome."""
    p = KssdParams.from_kmer_size(kmer_size, drlevel)
    table = get_shuffle_table(p.half_subk)
    threads = threads or (os.cpu_count() or 1)
    ss = SketchSet("kssd", p, False, p.use64)
    lib = native_mod.load_native()
    ptr = lib.rtc_sketch_sequences(
        os.fsencode(input_file), int(min_len), 0, p.half_k, p.half_subk,
        p.drlevel, table.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads)
    res = native_mod.SketchResultHandle(lib, ptr)
    b = res.bulk()
    flat = _finalize_dtype(b["flat_hashes"], p.use64)
    offs = b["offs"]
    keep = np.flatnonzero(b["total_len"] >= min_len)
    ss.file_names = [b["files"][i] for i in keep]
    ss.names = [b["names"][i] for i in keep]
    ss.comments = [b["comments"][i] for i in keep]
    ss.seq0_lens = b["seq0_len"][keep].tolist()
    ss.total_lens = b["total_len"][keep].tolist()
    ss.num_seqs = [1] * len(keep)
    ss.param_sizes = [0] * len(keep)
    ss.hashes = [flat[offs[i]:offs[i + 1]] for i in keep.tolist()]
    return ss, p

"""MinHash bottom-s sketching (Mash-compatible; reference default mode), by
the native host library.

Mash semantics: canonical k-mer = memcmp-smaller of k-mer and reverse
complement, MurmurHash3 seed 42 (x64_128 lower half for k > 16, x86_32
otherwise), keep the s smallest distinct hashes.

Modes (reference src/SketchInfo.cpp:702-711,918-924):
  * Mash/Jaccard: fixed sketch size s (default 1000)
  * AAF containment (-c): per-genome size max(len/containCompress, 100)
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from ..utils import native as native_mod
from .base import SketchSet


# Source: rabbittclust_tpu/sketch/minhash.py::MinHashParams
@dataclass(frozen=True)
class MinHashParams:
    kmer_size: int
    sketch_size: int            # fixed s (Jaccard mode); 0 in containment mode
    is_containment: bool = False
    contain_compress: int = 0   # sketch size ~ len/contain_compress

    @property
    def use64(self) -> bool:
        return self.kmer_size > 16


def _fill(ss: SketchSet, b: dict, keep: np.ndarray, by_file: bool) -> None:
    """The kept genomes of a native result's ``bulk()`` into ``ss``."""
    flat = b["flat_hashes"]
    offs = b["offs"]
    ss.file_names = [b["files"][i] for i in keep]
    ss.names = [b["names"][i] for i in keep]
    ss.comments = [b["comments"][i] for i in keep]
    ss.seq0_lens = b["seq0_len"][keep].tolist()
    ss.total_lens = b["total_len"][keep].tolist()
    ss.num_seqs = (b["num_seqs"][keep].tolist() if by_file
                   else [1] * len(keep))
    ss.param_sizes = b["param_size"][keep].tolist()
    ss.hashes = [flat[offs[i]:offs[i + 1]] for i in keep.tolist()]


# Source: rabbittclust_tpu/sketch/minhash.py::sketch_files_minhash (the
# native branch)
def sketch_files_minhash(files, min_len: int, p: MinHashParams,
                         threads: int = 0) -> SketchSet:
    threads = threads or (os.cpu_count() or 1)
    ss = SketchSet("minhash", p, True, True)
    lib = native_mod.load_native()
    arr, _keep = native_mod.make_file_array(files)
    if p.is_containment:
        ptr = lib.rtc_sketch_files_minhash_contain(
            arr, len(files), int(min_len), p.kmer_size,
            p.contain_compress, threads)
    else:
        ptr = lib.rtc_sketch_files(
            arr, len(files), int(min_len), 1, p.kmer_size,
            p.sketch_size, 0,
            ctypes.cast(None, ctypes.POINTER(ctypes.c_int32)), threads)
    b = native_mod.SketchResultHandle(lib, ptr).bulk()
    bad = np.flatnonzero(b["ok"] == 0)
    if len(bad):
        raise FileNotFoundError(
            f"cannot open the genome file: {files[int(bad[0])]}")
    _fill(ss, b, np.flatnonzero(b["total_len"] >= min_len), True)
    return ss


# Source: rabbittclust_tpu/sketch/minhash.py::sketch_sequences_minhash (the
# native branch)
def sketch_sequences_minhash(input_file: str, min_len: int, p: MinHashParams,
                             threads: int = 0) -> SketchSet:
    threads = threads or (os.cpu_count() or 1)
    ss = SketchSet("minhash", p, False, True)
    lib = native_mod.load_native()
    ptr = lib.rtc_sketch_sequences(
        os.fsencode(input_file), int(min_len), 1, p.kmer_size,
        p.sketch_size if not p.is_containment else 0,
        p.contain_compress if p.is_containment else 0,
        ctypes.cast(None, ctypes.POINTER(ctypes.c_int32)), threads)
    b = native_mod.SketchResultHandle(lib, ptr).bulk()
    _fill(ss, b, np.flatnonzero(b["total_len"] >= min_len), False)
    return ss

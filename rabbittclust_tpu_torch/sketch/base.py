"""The sketch-set container every engine of the port consumes: per-genome
sorted hash arrays plus genome metadata (reference analogue:
vector<KssdSketchInfo> / vector<SketchInfo>, src/SketchInfo.h:23-56), and
the greedy orderings.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np

from ..utils import native as native_mod


# Source: rabbittclust_tpu/sketch/base.py::stdsort_size_desc (the native
# libstdc++ sort only)
def stdsort_size_desc(sizes: np.ndarray) -> np.ndarray:
    """KSSD greedy ordering with REFERENCE tie order.  The reference sorts
    with std::sort and a size-only comparator (greedy.cpp:594-597) —
    UNSTABLE, so sketch-size ties land in libstdc++-introsort order, not id
    order.  The permutation comes bit-for-bit from the real libstdc++
    std::sort in the native library (rtc_stdsort_size_desc)."""
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    out = np.empty(len(sizes), dtype=np.int32)
    native_mod.load_native().rtc_stdsort_size_desc(
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(sizes)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out.astype(np.int64)


# Source: rabbittclust_tpu/sketch/base.py::SketchSet
@dataclass
class SketchSet:
    kind: str                      # "kssd" | "minhash"
    params: Any                    # KssdParams or MinHashParams
    sketch_by_file: bool
    use64: bool
    file_names: List[str] = field(default_factory=list)
    names: List[str] = field(default_factory=list)       # first-seq name per genome
    comments: List[str] = field(default_factory=list)    # first-seq comment
    seq0_lens: List[int] = field(default_factory=list)   # first-seq length
    total_lens: List[int] = field(default_factory=list)
    num_seqs: List[int] = field(default_factory=list)
    hashes: List[np.ndarray] = field(default_factory=list)  # sorted ascending
    # MinHash PARAMETER sketch size per genome — what the reference's
    # getSketchSize() returns: the fixed -s value in standard mode,
    # max(fileBytes/cc, 100) in containment mode (by-seq: max(len/cc, 100)),
    # and the contain_compress CONSTANT after a presketched load
    # (Sketch_IO.cpp:334-339 reconstructs MinHash(kmer, contain_compress)).
    # The MinHash greedy engine's bounds use this, not len(hashes).
    # Zeros for KSSD sets.
    param_sizes: List[int] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.hashes)

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(h) for h in self.hashes], dtype=np.int64)

    def display_length(self, i: int) -> int:
        """Length printed in .cluster rows: total genome length in by-file
        mode, first-sequence length in by-sequence mode
        (reference src/MST_IO.cpp:105-127)."""
        return self.total_lens[i] if self.sketch_by_file else self.seq0_lens[i]

    def append_genome(self, *, file_name: str, name: str, comment: str,
                      seq0_len: int, total_len: int, num_seqs: int,
                      hashes: np.ndarray, param_size: int = 0) -> int:
        self.file_names.append(file_name)
        self.names.append(name)
        self.comments.append(comment)
        self.seq0_lens.append(seq0_len)
        self.total_lens.append(total_len)
        self.num_seqs.append(num_seqs)
        self.hashes.append(hashes)
        self.param_sizes.append(param_size)
        return len(self.hashes) - 1

    def reorder(self, order: np.ndarray) -> "SketchSet":
        """Return a new SketchSet with genomes permuted by ``order``."""
        out = SketchSet(self.kind, self.params, self.sketch_by_file, self.use64)
        for i in order:
            out.append_genome(
                file_name=self.file_names[i], name=self.names[i],
                comment=self.comments[i], seq0_len=self.seq0_lens[i],
                total_len=self.total_lens[i], num_seqs=self.num_seqs[i],
                hashes=self.hashes[i], param_size=self.param_sizes[i])
        return out

    def sort_by_size_desc(self) -> np.ndarray:
        """Deterministic greedy ordering: sketch size descending, id
        ascending on ties.  Used where the reference's comparator also
        breaks ties by id (cmpGenomeSize/cmpSeqSize, SketchInfo.cpp:35-58)
        or where no parity constraint applies."""
        return np.lexsort((np.arange(len(self)), -self.sizes))

    def kssd_greedy_order(self) -> np.ndarray:
        """KSSD greedy ordering with REFERENCE tie order (see
        stdsort_size_desc)."""
        return stdsort_size_desc(self.sizes)

    def minhash_presketched_order(self) -> np.ndarray:
        """Ordering for the presketched MinHash greedy path: the reference
        sorts LOADED sketches by genome length descending, id ascending on
        ties (cmpGenomeSize/cmpSeqSize — deterministic comparators,
        sub_command.cpp:2658-2660; SketchInfo.cpp:35-58).  By-file mode
        keys on totalSeqLength, by-sequence on the sequence length."""
        lens = np.asarray(self.total_lens if self.sketch_by_file
                          else self.seq0_lens, dtype=np.int64)
        return np.lexsort((np.arange(len(self)), -lens))

    def extend(self, other: "SketchSet") -> None:
        if self.kind != other.kind or self.use64 != other.use64:
            raise ValueError(f"cannot extend a {self.kind} set (use64 "
                             f"{self.use64}) with a {other.kind} set (use64 "
                             f"{other.use64})")
        self.file_names.extend(other.file_names)
        self.names.extend(other.names)
        self.comments.extend(other.comments)
        self.seq0_lens.extend(other.seq0_lens)
        self.total_lens.extend(other.total_lens)
        self.num_seqs.extend(other.num_seqs)
        self.hashes.extend(other.hashes)
        self.param_sizes.extend(other.param_sizes)

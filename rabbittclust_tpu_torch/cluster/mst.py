"""MST clustering on the host: the native exact engine (the reference the
port's device engines are held to), Kruskal, the threshold forest cut and
BFS component labeling (reference clust-mst, src/MST.cpp:216-807).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..kernels._build import load_host
from ..utils import native as native_mod
from ..utils.profiling import count

DENSE_SPAN = 100  # reference common.hpp:26 (buckets of 0.01)


# Source: rabbittclust_tpu/cluster/mst.py::flatten_sketches
def flatten_sketches(hashes: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-genome sorted hash arrays into (hash, gid) columns."""
    if not hashes:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.int32))
    sizes = np.fromiter((len(h) for h in hashes), dtype=np.int64,
                        count=len(hashes))
    gid = np.repeat(np.arange(len(hashes), dtype=np.int32), sizes)
    hv = np.concatenate([np.asarray(h) for h in hashes])
    return hv, gid


# Source: rabbittclust_tpu/cluster/mst.py::native_pair_counts
def native_pair_counts(hashes: List[np.ndarray], j_min: float = 0.0,
                       ratio2: int = 0, start_index: int = 0,
                       threads: int = 0):
    """Native (i, j, common) over all pairs sharing >= 1 hash (i < j), with
    optional integer prefilters: common >= ceil(j_min*(sA+sB)/(1+j_min)) and
    max_size <= ratio2 * min_size (rtc_pairs_*)."""
    lib = native_mod.load_native()
    n = len(hashes)
    if n < 2:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), e.copy()
    use64 = hashes[0].dtype == np.uint64
    flat, offs = native_mod.flatten_csr(hashes, use64)
    fn = lib.rtc_pairs_u64 if use64 else lib.rtc_pairs_u32
    h = fn(flat.ctypes.data, offs.ctypes.data, n, j_min, ratio2,
           start_index, threads or (os.cpu_count() or 1))
    try:
        m = int(lib.rtc_pairs_count(h))
        pi = np.empty(m, dtype=np.int32)
        pj = np.empty(m, dtype=np.int32)
        common = np.empty(m, dtype=np.int32)
        if m:
            lib.rtc_pairs_data(h, pi.ctypes.data, pj.ctypes.data,
                               common.ctypes.data)
    finally:
        lib.rtc_pairs_free(h)
    return (pi.astype(np.int64), pj.astype(np.int64),
            common.astype(np.int64))


# ---------------------------------------------------------------------------
# Edge construction + streaming Kruskal
# ---------------------------------------------------------------------------

Edges = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (i int64, j int64, dist f64)


# Source: rabbittclust_tpu/cluster/mst.py::_empty_edges
def _empty_edges() -> Edges:
    return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.float64))


# Source: rabbittclust_tpu/cluster/mst.py::concat_edges
def concat_edges(parts: List[Edges]) -> Edges:
    if not parts:
        return _empty_edges()
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


# Source: rabbittclust_tpu/cluster/mst.py::sort_edges
def sort_edges(e: Edges) -> Edges:
    """Sort by (dist, i, j) — deterministic tie order.  The reference sorts
    by dist only with unstable std::sort; single-linkage clusters are
    invariant to tie order, so only edge-file byte order can differ."""
    i, j, d = e
    order = np.lexsort((j, i, d))
    return i[order], j[order], d[order]


# Source: rabbittclust_tpu/cluster/mst.py::kruskal (its sort and its
# union-find pass compiled: hostsrc/kruskal.cpp)
def kruskal(e: Edges, n: int, presorted: bool = False) -> Edges:
    """Minimum spanning forest via Kruskal (reference src/MST.cpp:59-75),
    in compiled host code (``hostsrc/kruskal.cpp``): the edges in
    ``sort_edges``'s (d, i, j) order (the given order when ``presorted``),
    a union-find with union by rank that stops at n - 1 kept, and the kept
    edges in that order.  Counts the edges given (``mst.kruskal_edges``)."""
    i, j, d = e
    m = len(i)
    count("mst.kruskal_edges", m)
    if m == 0:
        return _empty_edges()
    ei = np.ascontiguousarray(i, dtype=np.int64)
    ej = np.ascontiguousarray(j, dtype=np.int64)
    ed = np.ascontiguousarray(d, dtype=np.float64)
    kept = np.empty(min(m, max(n - 1, 0)), dtype=np.int64)
    n_kept = load_host().rtc_kruskal(ei.ctypes.data, ej.ctypes.data,
                                     ed.ctypes.data, m, int(n), int(presorted),
                                     kept.ctypes.data)
    if n_kept < 0:
        raise ValueError(f"kruskal: n ({n}) must lie in [0, 2**32) and "
                         f"every edge id in [0, n)")
    kept = kept[:n_kept]
    return i[kept], j[kept], d[kept]


# Source: rabbittclust_tpu/cluster/mst.py::MstResult
@dataclass
class MstResult:
    mst: Edges                          # spanning forest edges, Kruskal order
    n: int
    dense: Optional[np.ndarray] = None  # (DENSE_SPAN, n) cumulative counts
    ani: Optional[np.ndarray] = None    # (101,) histogram of int((1-d)*100)


# Source: rabbittclust_tpu/cluster/mst.py::compute_mst
def compute_mst(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    start_index: int = 0,
    with_dense: bool = False,
    pre_edges: Optional[Edges] = None,
    threads: int = 0,
) -> MstResult:
    """Full MST over candidate pairs (reference compute_kssd_mst semantics),
    by the native C++/OpenMP engine.

    ``pre_edges``: existing MST edges to merge (append mode,
    src/sub_command.cpp:1450-1457).
    """
    n = len(hashes)
    if n < 2:  # no pairs
        return MstResult(
            mst=_empty_edges(), n=n,
            dense=np.zeros((DENSE_SPAN, n), dtype=np.int64)
            if with_dense else None,
            ani=np.zeros(101, dtype=np.int64) if with_dense else None)
    mst, dense, ani = native_mod.native_mst(
        hashes, threshold, kmer_size, is_containment, start_index,
        with_dense, threads or (os.cpu_count() or 1))
    if pre_edges is not None and len(pre_edges[0]):
        mst = kruskal(concat_edges([pre_edges, mst]), n)
    return MstResult(mst=mst, n=n, dense=dense, ani=ani)


# ---------------------------------------------------------------------------
# Forest cut, components, noise
# ---------------------------------------------------------------------------

# Source: rabbittclust_tpu/cluster/mst.py::cut_forest
def cut_forest(mst: Edges, threshold: float) -> Edges:
    i, j, d = mst
    keep = d <= threshold
    return i[keep], j[keep], d[keep]


# Source: rabbittclust_tpu/cluster/mst.py::clusters_from_forest
def clusters_from_forest(forest: Edges, n: int) -> List[List[int]]:
    """Connected components via BFS, replicating reference member order
    (src/MST.cpp:109-142): adjacency in forest-edge order, BFS from the
    lowest unvisited id; by the native rtc_forest_clusters."""
    if not n:
        return []
    fi, fj, _ = forest
    lib = native_mod.load_native()
    ei = np.ascontiguousarray(fi, dtype=np.int64)
    ej = np.ascontiguousarray(fj, dtype=np.int64)
    order = np.empty(n, dtype=np.int32)
    bounds = np.empty(n + 1, dtype=np.int64)
    fn = lib.rtc_forest_clusters
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + \
        [ctypes.c_void_p] * 2
    nc = fn(ei.ctypes.data, ej.ctypes.data, len(ei), n, order.ctypes.data,
            bounds.ctypes.data)
    ol = order.tolist()
    return [ol[bounds[k]:bounds[k + 1]] for k in range(nc)]


# Source: rabbittclust_tpu/cluster/mst.py::get_noise_nodes
def get_noise_nodes(dense_row: np.ndarray, alpha: int = 2) -> np.ndarray:
    """Noise = nodes with density <= min(Q1-1, alpha) (src/MST.cpp:189-211).

    ``dense_row``: per-node neighbor counts at the cluster threshold bucket.
    """
    order = np.argsort(dense_row, kind="stable")
    q1 = int(dense_row[order[len(order) // 4]])
    thr = max(min(q1 - 1, alpha), 0)
    return order[dense_row[order] <= thr]


# Source: rabbittclust_tpu/cluster/mst.py::modify_forest
def modify_forest(forest: Edges, noise: np.ndarray) -> Edges:
    i, j, d = forest
    bad = np.isin(i, noise) | np.isin(j, noise)
    return i[~bad], j[~bad], d[~bad]

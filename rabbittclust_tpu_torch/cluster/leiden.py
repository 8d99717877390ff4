"""Graph-community clustering engine (clust-leiden: Louvain/Leiden).

Re-derivation of reference src/leiden.cpp:
  * graph construction (leiden.cpp:168-293): candidate pairs; edge iff
    dist < threshold with weight = 1 - dist; size-ratio filter min/max >=
    0.5; optional per-node top-k (k-NN) pruning over forward neighbors
    (j > i);
  * community detection: deterministic array-based Louvain (multi-level
    local moves) and Leiden (local move -> well-connectedness-gated
    refinement -> aggregation on the refined partition, Traag et al. 2019),
    whose hot loops run in the native library (``rtc_louvain_one_level``,
    ``rtc_leiden_refine_moves``, ``rtc_csr_build``); clusters are returned
    sorted by size descending (leiden.cpp:450-453);
  * graph persistence: "num_nodes num_edges" header + "from to weight"
    rows (save_graph_to_file, leiden.cpp:474-491).

The graph's pairs come from the native pair counts by default, also under
``--device``; ``RTC_LEIDEN_DEVICE=force`` takes them from the device
filter (``ops/bitmap.py::candidate_pairs_threshold``).  Both give the same
graph once pruned (``_knn_prune`` breaks ties canonically).
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distance.mash import mash_distance, min_jaccard_for_threshold
from ..utils import native as native_mod
from .mst import native_pair_counts

Graph = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (from, to, weight)

_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int64)


# Source: rabbittclust_tpu/cluster/leiden.py::build_similarity_graph
def build_similarity_graph(hashes: List[np.ndarray], threshold: float,
                           kmer_size: int, knn_k: int = 0,
                           use_device: bool = False,
                           device: Optional[torch.device] = None) -> Graph:
    n = len(hashes)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    ii_parts, jj_parts, ww_parts = [], [], []
    if use_device and os.environ.get("RTC_LEIDEN_DEVICE", "") != "force":
        print("-----leiden graph: routing --device to the native host "
              "engine (the default; the graph is byte-identical; "
              "RTC_LEIDEN_DEVICE=force takes the device filter)",
              file=sys.stderr)
        use_device = False
    if use_device:
        from ..ops.bitmap import candidate_pairs_threshold
        pairs_iter = [candidate_pairs_threshold(hashes, threshold, kmer_size,
                                                device=device)]
    else:
        # native fast path with a safe integer prefilter: the graph keeps
        # only d < threshold and ratio >= 0.5, so common >= bound(j_min) and
        # max <= 2*min are supersets (tiny slack guards f64-ceil rounding)
        j_min_slack = min_jaccard_for_threshold(threshold, kmer_size) \
            * (1.0 - 1e-9)
        pairs_iter = [native_pair_counts(hashes, j_min=j_min_slack,
                                         ratio2=2)]
    for i, j, c in pairs_iter:
        s0 = sizes[i]
        s1 = sizes[j]
        ratio = np.minimum(s0, s1) / np.maximum(np.maximum(s0, s1), 1)
        d = np.clip(mash_distance(c, s0, s1, kmer_size), 0.0, 1.0)
        keep = (ratio >= 0.5) & (d < threshold)
        ii_parts.append(i[keep])
        jj_parts.append(j[keep])
        ww_parts.append(1.0 - d[keep])
    if not ii_parts:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0, dtype=np.float64)
    ii = np.concatenate(ii_parts)
    jj = np.concatenate(jj_parts)
    ww = np.concatenate(ww_parts)
    return _knn_prune(np.minimum(ii, jj), np.maximum(ii, jj), ww, knn_k)


# Source: rabbittclust_tpu/cluster/leiden.py::_knn_prune
def _knn_prune(frm, to, ww, knn_k: int) -> Graph:
    """Per-node top-k over forward neighbors (smaller id is "from";
    reference keeps top-k of {j > i} per i, leiden.cpp:195-231).  Ties at
    the k-th cut break by neighbor id ascending — canonical and
    independent of the pair enumeration order."""
    if knn_k <= 0 or not len(frm):
        return frm, to, ww
    order = np.lexsort((to, 1.0 - ww, frm))  # from, dist asc, id asc
    frm, to, ww = frm[order], to[order], ww[order]
    starts = np.flatnonzero(np.r_[True, frm[1:] != frm[:-1]])
    lens = np.diff(np.r_[starts, len(frm)])
    rank = np.arange(len(frm)) - np.repeat(starts, lens)
    keep = rank < knn_k
    return frm[keep], to[keep], ww[keep]


# Source: rabbittclust_tpu/cluster/leiden.py::save_graph
def save_graph(graph: Graph, num_nodes: int, path: str) -> None:
    frm, to, w = graph
    with open(path, "w") as f:
        f.write(f"{num_nodes} {len(frm)}\n")
        for a, b, x in zip(frm.tolist(), to.tolist(), w.tolist()):
            f.write(f"{a} {b} {x:g}\n")
    print(f"-----Graph saved to: {path}", file=sys.stderr)


# Source: rabbittclust_tpu/cluster/leiden.py::load_graph
def load_graph(path: str) -> Tuple[int, Graph]:
    with open(path) as f:
        header = f.readline().split()
        n, m = int(header[0]), int(header[1])
        frm = np.empty(m, dtype=np.int64)
        to = np.empty(m, dtype=np.int64)
        w = np.empty(m, dtype=np.float64)
        for k in range(m):
            a, b, x = f.readline().split()
            frm[k], to[k], w[k] = int(a), int(b), float(x)
    return n, (frm, to, w)


# Source: rabbittclust_tpu/cluster/leiden.py::_one_level (the native branch)
def _one_level(n: int, adj_idx, adj_nbr, adj_w, k_arr, two_m,
               resolution: float,
               init: Optional[np.ndarray] = None) -> Tuple[np.ndarray, bool]:
    """One Louvain level: local moves until stable, nodes in ascending
    order, best community by max gain, ties to the lowest id; ``init``
    seeds the starting membership (Leiden levels)."""
    if n == 0:
        return np.empty(0, dtype=np.int64), False
    lib = native_mod.load_native()
    adj_idx = np.ascontiguousarray(adj_idx, dtype=np.int64)
    adj_nbr = np.ascontiguousarray(adj_nbr, dtype=np.int64)
    adj_w = np.ascontiguousarray(adj_w, dtype=np.float64)
    k_arr = np.ascontiguousarray(k_arr, dtype=np.float64)
    comm = np.empty(n, dtype=np.int64)
    if init is None:
        init_ptr = None
        tot_len = n
    else:
        init = np.ascontiguousarray(init, dtype=np.int64)
        init_ptr = init.ctypes.data_as(ctypes.c_void_p)
        tot_len = max(n, int(init.max()) + 1)
    improved = lib.rtc_louvain_one_level(
        n, adj_idx.ctypes.data_as(_ip), adj_nbr.ctypes.data_as(_ip),
        adj_w.ctypes.data_as(_dp), k_arr.ctypes.data_as(_dp),
        float(two_m), float(resolution), init_ptr, tot_len,
        comm.ctypes.data_as(_ip))
    return comm, bool(improved)


# Source: rabbittclust_tpu/cluster/leiden.py::_level_csr (the native branch)
def _level_csr(cur_n: int, frm, to, w):
    """(adj_idx, adj_nbr, adj_w, deg_w) for one level, by the native
    counting sort (the order of np.argsort(concat(frm, to), stable) and the
    np.add.at degree order)."""
    frm = np.ascontiguousarray(frm, dtype=np.int64)
    to = np.ascontiguousarray(to, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    m = len(frm)
    adj_idx = np.zeros(cur_n + 1, dtype=np.int64)
    adj_nbr = np.empty(2 * m, dtype=np.int64)
    adj_w = np.empty(2 * m, dtype=np.float64)
    deg_w = np.zeros(cur_n, dtype=np.float64)
    if cur_n:
        native_mod.load_native().rtc_csr_build(
            cur_n, m, frm.ctypes.data_as(_ip), to.ctypes.data_as(_ip),
            w.ctypes.data_as(_dp), adj_idx.ctypes.data_as(_ip),
            adj_nbr.ctypes.data_as(_ip), adj_w.ctypes.data_as(_dp),
            deg_w.ctypes.data_as(_dp))
    return adj_idx, adj_nbr, adj_w, deg_w


# Source: rabbittclust_tpu/cluster/leiden.py::_compact_by_value
def _compact_by_value(arr: np.ndarray, bound: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(inverse, uniq) == np.unique(arr, return_inverse=True) for
    nonnegative ints < bound — O(n + bound) flag/cumsum, no sort."""
    present = np.zeros(bound, dtype=bool)
    present[arr] = True
    newid = np.cumsum(present) - 1
    return newid[arr], np.flatnonzero(present)


# Source: rabbittclust_tpu/cluster/leiden.py::_aggregate
def _aggregate(comm_compact, n_comm: int, frm, to, w):
    """Aggregated (frm, to, w) over the compact membership (bincount
    accumulates per bin in input order, exactly like add.at on a zero
    array)."""
    cf = comm_compact[frm]
    ct = comm_compact[to]
    a = np.minimum(cf, ct)
    b = np.maximum(cf, ct)
    key = a * n_comm + b
    if n_comm * n_comm <= max(1 << 26, 4 * len(key)):
        inv, uk = _compact_by_value(key, n_comm * n_comm)
    else:
        uk, inv = np.unique(key, return_inverse=True)
    agg_w = np.bincount(inv, weights=w, minlength=len(uk))
    return ((uk // n_comm).astype(np.int64), (uk % n_comm).astype(np.int64),
            agg_w)


# Source: rabbittclust_tpu/cluster/leiden.py::louvain
def louvain(n: int, graph: Graph, resolution: float = 1.0
            ) -> np.ndarray:
    """Returns membership array (n,) of community ids (renumbered 0..)."""
    frm, to, w = graph
    membership = np.arange(n, dtype=np.int64)
    cur_n = n
    cur_frm, cur_to, cur_w = (frm.astype(np.int64), to.astype(np.int64),
                              w.astype(np.float64))
    for _level in range(32):
        if len(cur_frm) == 0:
            break
        adj_idx, dst, ww2, deg_w = _level_csr(cur_n, cur_frm, cur_to, cur_w)
        two_m = deg_w.sum()
        if two_m <= 0:
            break
        comm, improved = _one_level(cur_n, adj_idx, dst, ww2, deg_w, two_m,
                                    resolution)
        comm_compact, uniq = _compact_by_value(comm, cur_n)
        membership = comm_compact[membership]
        if not improved or len(uniq) == cur_n:
            break
        cur_frm, cur_to, cur_w = _aggregate(comm_compact, len(uniq),
                                            cur_frm, cur_to, cur_w)
        cur_n = len(uniq)
    final, _ = _compact_by_value(membership, n)
    return final


# Source: rabbittclust_tpu/cluster/leiden.py::_refine (the native branch)
def _refine(n: int, adj_idx, adj_nbr, adj_w, k_arr, two_m, comm,
            resolution: float) -> np.ndarray:
    """Leiden refinement phase (Traag et al. 2019, deterministic variant):
    within each community nodes start as singletons; a still-singleton,
    well-connected node may move into a well-connected subcommunity of the
    same community, max gain with ties to the lowest subcommunity id."""
    comm_tot = np.zeros(int(comm.max()) + 1 if n else 0, dtype=np.float64)
    np.add.at(comm_tot, comm, k_arr)
    adj_idx = np.ascontiguousarray(adj_idx, dtype=np.int64)
    adj_nbr = np.ascontiguousarray(adj_nbr, dtype=np.int64)
    adj_w = np.ascontiguousarray(adj_w, dtype=np.float64)
    node_of_pos = np.repeat(np.arange(n), np.diff(adj_idx))
    same = comm[adj_nbr] == comm[node_of_pos]
    ext = np.bincount(node_of_pos, weights=np.where(same, adj_w, 0.0),
                      minlength=n)
    well_v = ext >= resolution * k_arr * (comm_tot[comm] - k_arr) / two_m
    if not n:
        return np.arange(n, dtype=np.int64)
    k_arr = np.ascontiguousarray(k_arr, dtype=np.float64)
    comm_c = np.ascontiguousarray(comm, dtype=np.int64)
    well_c = np.ascontiguousarray(well_v, dtype=np.uint8)
    sub = np.empty(n, dtype=np.int64)
    native_mod.load_native().rtc_leiden_refine_moves(
        n, adj_idx.ctypes.data_as(_ip), adj_nbr.ctypes.data_as(_ip),
        adj_w.ctypes.data_as(_dp), k_arr.ctypes.data_as(_dp),
        float(two_m), comm_c.ctypes.data_as(_ip), float(resolution),
        comm_tot.ctypes.data_as(_dp), ext.ctypes.data_as(_dp),
        well_c.ctypes.data_as(ctypes.c_void_p), sub.ctypes.data_as(_ip))
    return sub


# Source: rabbittclust_tpu/cluster/leiden.py::leiden
def leiden(n: int, graph: Graph, resolution: float = 1.0) -> np.ndarray:
    """Deterministic Leiden: local move -> refine -> aggregate on the refined
    partition with the unrefined partition as the next level's start.
    Returns membership (n,) renumbered 0.."""
    frm, to, w = graph
    membership = np.arange(n, dtype=np.int64)
    cur_n = n
    cur_frm, cur_to, cur_w = (frm.astype(np.int64), to.astype(np.int64),
                              w.astype(np.float64))
    init: Optional[np.ndarray] = None
    for _level in range(32):
        if len(cur_frm) == 0:
            break
        adj_idx, dst, ww2, deg_w = _level_csr(cur_n, cur_frm, cur_to, cur_w)
        two_m = deg_w.sum()
        if two_m <= 0:
            break
        comm, improved = _one_level(cur_n, adj_idx, dst, ww2, deg_w, two_m,
                                    resolution, init=init)
        comm_bound = cur_n if init is None else max(cur_n,
                                                    int(init.max()) + 1)
        comm, _ = _compact_by_value(comm, comm_bound)
        if not improved:
            membership = comm[membership]
            break
        refined = _refine(cur_n, adj_idx, dst, ww2, deg_w, two_m, comm,
                          resolution)
        ref_compact, uniq_r = _compact_by_value(refined, cur_n)
        membership = ref_compact[membership]
        if len(uniq_r) == cur_n:
            # refinement left every aggregate node a singleton: converged.
            # Final communities are the unrefined partition of this level.
            membership = comm[_first_of_groups(ref_compact,
                                               len(uniq_r))][membership]
            break
        cur_frm, cur_to, cur_w = _aggregate(ref_compact, len(uniq_r),
                                            cur_frm, cur_to, cur_w)
        # next level starts from the UNREFINED communities: each refined
        # subcommunity's initial community is its parent community in comm
        init = comm[_first_of_groups(ref_compact, len(uniq_r))]
        cur_n = len(uniq_r)
    final, _ = _compact_by_value(membership, n)
    return final


# Source: rabbittclust_tpu/cluster/leiden.py::_first_of_groups
def _first_of_groups(compact: np.ndarray, k: int) -> np.ndarray:
    """Lowest original index of each group id 0..k-1 in ``compact``."""
    first = np.full(k, len(compact), dtype=np.int64)
    np.minimum.at(first, compact, np.arange(len(compact)))
    return first


# Source: rabbittclust_tpu/cluster/leiden.py::community_clusters (without
# the multi-chip graph)
def community_clusters(hashes: List[np.ndarray], threshold: float,
                       kmer_size: int, resolution: float = 1.0,
                       use_leiden: bool = True, knn_k: int = 0,
                       graph_save_path: Optional[str] = None,
                       use_device: bool = False,
                       edge_parallel: bool = False,
                       device: Optional[torch.device] = None
                       ) -> List[List[int]]:
    n = len(hashes)
    if n == 0:
        return []
    graph = build_similarity_graph(hashes, threshold, kmer_size, knn_k,
                                   use_device, device)
    print(f"-----Edges created: {len(graph[0])}", file=sys.stderr)
    if graph_save_path:
        save_graph(graph, n, graph_save_path)
    return cluster_graph(n, graph, resolution, use_leiden,
                         edge_parallel=edge_parallel)


# Source: rabbittclust_tpu/cluster/leiden.py::cluster_graph
def cluster_graph(n: int, graph: Graph, resolution: float,
                  use_leiden: bool,
                  edge_parallel: bool = False) -> List[List[int]]:
    frm, to, w = graph
    if len(frm) == 0:
        return [[i] for i in range(n)]
    if use_leiden:
        # reference normalizes narrow weight ranges before Leiden
        # (leiden.cpp:343-366)
        wmin, wmax = float(w.min()), float(w.max())
        if wmax - wmin < 0.5 and wmax - wmin > 1e-6:
            w = (w - wmin) / (wmax - wmin)
    if edge_parallel:
        membership = louvain_edge_parallel(n, (frm, to, w), resolution)
    elif use_leiden:
        membership = leiden(n, (frm, to, w), resolution)
    else:
        membership = louvain(n, (frm, to, w), resolution)
    clusters: Dict[int, List[int]] = {}
    for i, c in enumerate(membership.tolist()):
        clusters.setdefault(c, []).append(i)
    result = list(clusters.values())
    result.sort(key=len, reverse=True)
    print(f"-----Number of clusters: {len(result)}", file=sys.stderr)
    return result


# Source: rabbittclust_tpu/cluster/leiden.py::modularity
def modularity(n: int, graph: Graph, membership: np.ndarray,
               resolution: float = 1.0) -> float:
    frm, to, w = graph
    if len(frm) == 0:
        return 0.0
    # bincount == add.at on a zero array (per-bin input-order accumulation)
    deg = np.bincount(frm, weights=w, minlength=n)
    deg += np.bincount(to, weights=w, minlength=n)
    two_m = deg.sum()
    if two_m <= 0:
        return 0.0
    intra = w[membership[frm] == membership[to]].sum()
    comm_deg = np.bincount(membership, weights=deg,
                           minlength=int(membership.max()) + 1)
    return float(2.0 * intra / two_m -
                 resolution * np.sum((comm_deg / two_m) ** 2))


# Source: rabbittclust_tpu/cluster/leiden.py::louvain_edge_parallel
def louvain_edge_parallel(n: int, graph: Graph, resolution: float = 1.0,
                          partitions: int = 4,
                          warm_start: bool = True) -> np.ndarray:
    """Edge-parallel Louvain with warm start (reference
    KssdEdgeParallelLouvainCluster, leiden.cpp:1449-1746): edges are split
    into partitions, local Louvain runs per edge subset, the best local
    membership (by modularity on the full graph) seeds the final pass."""
    frm, to, w = graph
    if len(frm) == 0 or not warm_start or partitions <= 1:
        return louvain(n, graph, resolution)
    bounds = np.linspace(0, len(frm), partitions + 1).astype(np.int64)
    best_mem = None
    best_q = -np.inf
    for p in range(partitions):
        sl = slice(bounds[p], bounds[p + 1])
        if bounds[p + 1] - bounds[p] == 0:
            continue
        mem = louvain(n, (frm[sl], to[sl], w[sl]), resolution)
        q = modularity(n, graph, mem, resolution)
        if q > best_q:
            best_q = q
            best_mem = mem
    if best_mem is None:
        return louvain(n, graph, resolution)
    # aggregate the full graph by the warm membership, cluster the
    # supergraph, and compose
    n_comm = int(best_mem.max()) + 1
    super_mem = louvain(n_comm,
                        _aggregate(best_mem.astype(np.int64), n_comm,
                                   frm, to, w),
                        resolution)
    composed = super_mem[best_mem]
    # keep whichever is better: warm-start composition or plain Louvain
    plain = louvain(n, graph, resolution)
    if modularity(n, graph, composed, resolution) >= \
            modularity(n, graph, plain, resolution):
        _, out = np.unique(composed, return_inverse=True)
    else:
        _, out = np.unique(plain, return_inverse=True)
    return out

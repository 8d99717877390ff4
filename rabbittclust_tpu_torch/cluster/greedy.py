"""Greedy incremental clustering (clust-greedy engines) by the native host
library.

Re-derivation of the reference flagship algorithm
``KssdGreedyClusterWithInvertedIndex`` (src/greedy.cpp:566-899):

  1. sort genomes by sketch size descending (CD-HIT convention);
  2. serial outer loop; the first genome seeds cluster 0;
  3. probe a representative-only inverted index for intersection counts;
  4. candidate filter: common >= ceil(j_min*(|A|+|B|)/(1+j_min)) with
     j_min = e^{-dk}/(2-e^{-dk});
  5. best match = max Jaccard (monotone in Mash distance; ties resolved by
     first touch order, matching the reference's single-thread semantics);
  6. assign to the best rep's cluster, else become a new representative;
  7. monotonic pruning: evict reps larger than min_seen/(j_min*0.8) every
     100K (datasets < 500K) or 1M genomes — they can never match again.

Clusters are reported in representative-creation order with the
representative first (src/greedy.cpp:854-867).  Both engines run in the
native library (``rtc_greedy_*``, ``rtc_greedy_minhash``); the port has no
Python fallback.  ``greedy_cluster_batched`` (the reference's experimental
batched variant, over a Python inverted index) is the oracle of the batched
device route, ``ops/greedy_device.py`` with ``conflict="batched"``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..distance.mash import min_jaccard_for_threshold
from ..utils import native as native_mod


# Source: rabbittclust_tpu/cluster/greedy.py::GreedyResult
@dataclass
class GreedyResult:
    clusters: List[List[int]]       # in original (input) genome ids
    representatives: List[int]      # original ids, one per cluster
    order: np.ndarray               # size-desc permutation used internally


# Source: rabbittclust_tpu/cluster/greedy.py::RepInvertedIndex (what
# greedy_cluster_batched calls)
class RepInvertedIndex:
    """Dynamic hash -> [rep_id] index over representatives only
    (reference DynamicInvertedIndex, src/greedy.cpp:361-520)."""

    def __init__(self):
        self.index: Dict[int, List[int]] = {}

    def add_representative(self, rep_id: int, hashes: np.ndarray) -> None:
        idx = self.index
        for h in hashes.tolist():
            lst = idx.get(h)
            if lst is None:
                idx[h] = [rep_id]
            else:
                lst.append(rep_id)

    def probe(self, hashes: np.ndarray):
        """Intersection counts with every rep sharing >= 1 hash.
        Returns (touched_rep_ids, counts) in first-touch order."""
        idx = self.index
        cnt: Dict[int, int] = {}
        for h in hashes.tolist():
            lst = idx.get(h)
            if lst is None:
                continue
            for r in lst:
                cnt[r] = cnt.get(r, 0) + 1
        # Python dicts preserve insertion (first-touch) order.
        return list(cnt.keys()), list(cnt.values())


# Source: rabbittclust_tpu/cluster/greedy.py::greedy_cluster_batched
def greedy_cluster_batched(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    batch_size: int = 64,
    presorted: bool = False,
    is_containment: bool = False,
) -> GreedyResult:
    """Batched greedy variant (reference
    KssdGreedyClusterWithInvertedIndexBatched, greedy.cpp:1412-1543):
    each batch matches against the representative index snapshot in
    parallel (min exact distance <= threshold); conflicts are resolved by
    inserting results in distance-descending order, so would-be
    representatives are registered before closer matches are assigned.
    Exact-distance ties go to the smallest rep id (the reference iterates an
    unordered_map, i.e. its tie order is unspecified); the device variant
    (ops/greedy_device.py) reproduces this tie-break bit-exactly.
    """
    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    if presorted:
        order = np.arange(n, dtype=np.int64)
        inv = list(hashes)
    else:
        sizes0 = np.array([len(h) for h in hashes], dtype=np.int64)
        order = np.lexsort((np.arange(n), -sizes0))
        inv = [hashes[i] for i in order]
    sizes = np.array([len(h) for h in inv], dtype=np.int64)

    index = RepInvertedIndex()
    rep_order: List[int] = [0]
    members: Dict[int, List[int]] = {0: []}
    index.add_representative(0, inv[0])

    def mash(common, s0, s1):
        denom = s0 + s1 - common
        if s0 == 0 or s1 == 0 or denom == 0:
            return 1.0
        j = common / denom
        if j == 1.0:
            return 0.0
        if j == 0.0:
            return 1.0
        d = -math.log(2 * j / (1.0 + j)) / kmer_size
        return min(d, 1.0)

    def aaf(common, s0, s1):
        mn = min(s0, s1)
        if mn == 0:
            return 1.0
        c = common / mn
        if c == 1.0:
            return 0.0
        if c == 0.0:
            return 1.0
        return min(-math.log(c) / kmer_size, 1.0)

    dist_fn = aaf if is_containment else mash

    for b0 in range(1, n, batch_size):
        b1 = min(b0 + batch_size, n)
        results = []
        for j in range(b0, b1):
            touched, counts = index.probe(inv[j])
            best_d, best_rep = float("inf"), -1
            for rep_id, common in zip(touched, counts):
                d = dist_fn(common, int(sizes[j]), int(sizes[rep_id]))
                if d <= threshold and (d < best_d or
                                       (d == best_d and rep_id < best_rep)):
                    best_d, best_rep = d, rep_id
            results.append((j, best_d, best_rep))
        # distance-descending conflict resolution (ties: stable)
        results.sort(key=lambda t: -t[1])
        for j, _d, rep in results:
            if rep != -1:
                members[rep].append(j)
            else:
                rep_order.append(j)
                members[j] = []
                index.add_representative(j, inv[j])

    clusters = [[int(order[r])] + [int(order[m]) for m in members[r]]
                for r in rep_order]
    reps_orig = [int(order[r]) for r in rep_order]
    return GreedyResult(clusters=clusters, representatives=reps_orig,
                        order=order)


# Source: rabbittclust_tpu/cluster/greedy.py::_greedy_native
def _greedy_native(inv: List[np.ndarray], j_min: float, c_min: float,
                   is_containment: bool, prune_interval: int) -> np.ndarray:
    """Native C++ serial greedy (rtc_greedy_*): returns best_out[j] = chosen
    rep (sorted index) or -1 (first-touch order, f64 bounds, monotonic
    pruning)."""
    lib = native_mod.load_native()
    n = len(inv)
    use64 = inv[0].dtype == np.uint64
    flat, offs = native_mod.flatten_csr(inv, use64)
    best = np.empty(n, dtype=np.int32)
    fn = lib.rtc_greedy_u64 if use64 else lib.rtc_greedy_u32
    fn(flat.ctypes.data, offs.ctypes.data, n, j_min, c_min,
       1 if is_containment else 0, prune_interval, best.ctypes.data)
    return best


# Source: rabbittclust_tpu/cluster/greedy.py::greedy_cluster (the native
# engine)
def greedy_cluster(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    presorted: bool = False,
    is_containment: bool = False,
    prune_interval: int = 0,
) -> GreedyResult:
    """Greedy incremental clustering over sketch hash arrays.

    With ``presorted=False`` the size-descending sort (ties by id) is applied
    internally and results are mapped back to original ids; the reference
    instead sorts its sketch vector in place and reports sorted ids — the
    orchestration layer reorders the SketchSet first and passes
    ``presorted=True`` to reproduce that numbering.

    ``is_containment`` switches the similarity to the AAF containment
    coefficient c = common/min(|A|,|B|) with bound common >= ceil(c_min *
    min sizes), c_min = e^{-dk}.
    """
    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    if presorted:
        order = np.arange(n, dtype=np.int64)
        inv = list(hashes)
    else:
        sizes0 = np.array([len(h) for h in hashes], dtype=np.int64)
        order = np.lexsort((np.arange(n), -sizes0))
        inv = [hashes[i] for i in order]

    j_min = min_jaccard_for_threshold(threshold, kmer_size)
    c_min = math.exp(-threshold * kmer_size)
    if prune_interval <= 0:
        prune_interval = 100_000 if n < 500_000 else 1_000_000

    best = _greedy_native(inv, j_min, c_min, is_containment, prune_interval)
    representatives = [0]
    rep2cid = {0: 0}
    members: List[List[int]] = [[]]
    for j in range(1, n):
        b = int(best[j])
        if b >= 0:
            members[rep2cid[b]].append(j)
        else:
            rep2cid[j] = len(representatives)
            representatives.append(j)
            members.append([])
    clusters = [[int(order[rep])] + [int(order[m]) for m in mem]
                for rep, mem in zip(representatives, members)]
    return GreedyResult(
        clusters=clusters,
        representatives=[int(order[r]) for r in representatives],
        order=order)


# Source: rabbittclust_tpu/cluster/greedy.py::minhash_greedy_parity (the
# native engine)
def minhash_greedy_parity(
    hashes: List[np.ndarray],
    param_sizes: List[int],
    threshold: float,
    kmer_size: int,
    is_containment: bool,
) -> GreedyResult:
    """Reference-parity MinHash greedy (MinHashGreedyClusterWithInvertedIndex,
    src/greedy.cpp:986-1360 — the DEFAULT clust-greedy MinHash engine).

    The caller passes genomes in the REFERENCE order: input order for fresh
    genomes (compute_clusters does NOT sort, sub_command.cpp:2891-2914),
    length-descending (id ties) for the presketched path
    (cmpGenomeSize/cmpSeqSize, sub_command.cpp:2658-2660).

    ``param_sizes[i]`` is the reference's per-genome getSketchSize(): the
    fixed -s value in standard mode, max(fileBytes/cc, 100) for fresh
    containment sketches, and the contain_compress CONSTANT after a
    presketched load (Sketch_IO.cpp:333-339).  Bounds and distances use it
    for the REP side while the query side uses the actual kept-hash count
    — an asymmetry the reference has and the native engine replicates
    (no sort, no pruning, first-touch candidate order; fast path iff the
    first min(100, n) genomes are standard-mode with one param size).
    """
    n = len(hashes)
    if n == 0:
        return GreedyResult([], [], np.empty(0, dtype=np.int64))
    order = np.arange(n, dtype=np.int64)
    psizes = np.asarray(param_sizes, dtype=np.int64)
    if len(psizes) != n:
        raise ValueError(f"{len(psizes)} param sizes for {n} genomes")
    best = _minhash_parity_native(hashes, psizes, threshold, kmer_size,
                                  is_containment)

    representatives = [0]
    rep2cid = {0: 0}
    members: List[List[int]] = [[]]
    for j in range(1, n):
        b = int(best[j])
        if b >= 0:
            members[rep2cid[b]].append(j)
        else:
            rep2cid[j] = len(representatives)
            representatives.append(j)
            members.append([])
    clusters = [[rep] + mem for rep, mem in zip(representatives, members)]
    return GreedyResult(clusters=clusters, representatives=representatives,
                        order=order)


# Source: rabbittclust_tpu/cluster/greedy.py::_minhash_parity_native
def _minhash_parity_native(hashes, psizes, threshold, kmer_size,
                           is_containment) -> np.ndarray:
    lib = native_mod.load_native()
    n = len(hashes)
    flat = np.concatenate(hashes).astype(np.uint64)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(h) for h in hashes], out=offs[1:])
    psizes = np.ascontiguousarray(psizes, dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    lib.rtc_greedy_minhash(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        psizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_double(threshold), ctypes.c_int(kmer_size),
        ctypes.c_int(int(is_containment)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out

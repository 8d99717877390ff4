"""Exact threshold clustering without an MST (counterpart of
``rabbittclust_tpu/ops/cluster_fast.py``): the bitmap filter on the GPU
plus the union-find-gated exact verify on the host.

``threshold_clusters_device`` picks the engine by size, as the JAX package
does: the stream engine (``ops/bitmap.py::candidate_pair_blocks``, K1, host
verify of every pulled block) at or below 16,384 genomes, the resident-mask
label-propagation engine (``ops/labelprop.py``, K1 + K2) above.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np
import torch

from ..cluster.mst import clusters_from_forest, cut_forest, kruskal
from ..cluster.union_find import UnionFind
from ..device import resolve_device
from ..distance.mash import aaf_distance, mash_distance
from ..utils import native as native_mod
from ..utils.native import native_intra_mst, native_mst
from ..utils.profiling import maybe_trace
from .bitmap import CsrSketches, candidate_pair_blocks

ENGINES = ("auto", "stream", "lp")


def _checked_settings(bits: int, row_block: int, engine: str):
    """``RTC_CLUSTER_BITS``, ``RTC_CLUSTER_RB`` and ``RTC_CLUSTER_ENGINE``
    over the arguments, validated: K1 works on whole 64-bit signature words
    (and the shared native pack reads whole words too), and on tiles of a
    multiple of 32 rows."""
    bits = int(os.environ.get("RTC_CLUSTER_BITS", bits))
    row_block = int(os.environ.get("RTC_CLUSTER_RB", row_block))
    engine = os.environ.get("RTC_CLUSTER_ENGINE", engine)
    if bits < 64 or bits & (bits - 1):
        raise ValueError(f"signature bits {bits}: must be a power of two "
                         ">= 64")
    if row_block <= 0 or row_block % 32:
        raise ValueError(f"row block {row_block}: must be a positive "
                         "multiple of 32")
    if engine not in ENGINES:
        raise ValueError(f"cluster engine {engine!r}: one of {ENGINES}")
    return bits, row_block, engine


def threshold_clusters_device(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    bits: int = 8192,
    row_block: int = 4096,
    verify_chunk: int = 65536,
    engine: str = "auto",
    device: Optional[torch.device] = None,
) -> List[List[int]]:
    """Exact single-linkage clusters at ``threshold`` (BFS-ordered like the
    reference MST cut), equal to the JAX ``threshold_clusters_device``'s."""
    n = len(hashes)
    if n == 0:
        return []
    bits, row_block, engine = _checked_settings(bits, row_block, engine)
    if engine == "auto":
        engine = "lp" if n > 16384 else "stream"
    if engine == "lp":
        from .labelprop import threshold_clusters_device_lp
        return threshold_clusters_device_lp(
            hashes, threshold, kmer_size, is_containment=is_containment,
            bits=bits, row_block=max(row_block, 4096), device=device)
    device = resolve_device(device)
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    uf = UnionFind(n)
    kept_i: List[int] = []
    kept_j: List[int] = []
    kept_d: List[float] = []
    csr = CsrSketches(hashes)  # built once, reused by every block
    with maybe_trace("bitmap_filter_cluster", device):
        for ii, jj in candidate_pair_blocks(
                hashes, threshold, kmer_size, is_containment=is_containment,
                bits=bits, row_block=row_block, device=device):
            _gated_verify_block(uf, csr, sizes, ii, jj, threshold,
                                kmer_size, is_containment, kept_i, kept_j,
                                kept_d, verify_chunk)
    # the kept edges span every component: BFS from the lowest id
    forest = kruskal((np.asarray(kept_i, dtype=np.int64),
                      np.asarray(kept_j, dtype=np.int64),
                      np.asarray(kept_d, dtype=np.float64)), n)
    return clusters_from_forest(forest, n)


def threshold_clusters_device_exact_order(
    hashes: List[np.ndarray],
    threshold: float,
    kmer_size: int,
    is_containment: bool = False,
    **kwargs,
) -> "tuple[List[List[int]], bool]":
    """The device partition in the reference's ``-t 1`` member order.

    The shared native ``native_intra_mst`` replays the serial
    streaming-Kruskal cadence over each cluster's internal candidates; when
    a hash is shared across clusters (no certificate) the full serial native
    engine runs instead.  Returns (clusters, certified), as the JAX
    function does."""
    n = len(hashes)
    clusters = threshold_clusters_device(hashes, threshold, kmer_size,
                                         is_containment=is_containment,
                                         **kwargs)
    res = native_intra_mst(hashes, labels_from_clusters(clusters, n),
                           threshold, kmer_size, is_containment,
                           abort_on_cross=True)
    edges, has_cross = res
    if has_cross:
        edges = native_mst(hashes, threshold, kmer_size, is_containment, 0,
                           False, 1)[0]
    ordered = clusters_from_forest(cut_forest(edges, threshold), n)
    # the (label_a, label_b) relation must be a bijection
    la = labels_from_clusters(clusters, n).astype(np.int64)
    lb = labels_from_clusters(ordered, n).astype(np.int64)
    if len(np.unique(la * len(ordered) + lb)) != len(clusters) or \
            len(clusters) != len(ordered):
        raise RuntimeError(
            "the serial-order finish changed the partition "
            f"({len(ordered)} vs {len(clusters)} clusters)")
    return ordered, not has_cross


# Source: rabbittclust_tpu/ops/cluster_fast.py::labels_from_clusters
def labels_from_clusters(clusters: List[List[int]], n: int) -> np.ndarray:
    labels = np.empty(n, dtype=np.int32)
    for ci, members in enumerate(clusters):
        labels[members] = ci
    return labels


# Source: rabbittclust_tpu/ops/cluster_fast.py::gated_verify_merge
def gated_verify_merge(uf, csr, sizes, ii, jj, threshold, kmer_size,
                       is_containment):
    """Exact-verify the (ii, jj) pairs and merge passes into ``uf`` in one
    native pass (count_common + float64 libm distance + union-find, see
    rtc_verify_merge_* in native/rtc_native.cpp).  Returns
    (kept_i, kept_j, kept_d, ok): the kept edges — pairs that verified at
    d <= threshold AND connected two previously separate components — in
    input order, plus the per-pair verified-pass mask (False = verified
    FAIL, the caller's clear-list).  libm log keeps distances bit-identical
    to the native MST engine."""
    m = len(ii)
    if m == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), np.empty(0, dtype=np.float64), \
            np.empty(0, dtype=bool)
    lib = native_mod.load_native()
    fn = lib.rtc_verify_merge_u64 if csr.use64 else lib.rtc_verify_merge_u32
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_double, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int]
    ii64 = np.ascontiguousarray(ii, dtype=np.int64)
    jj64 = np.ascontiguousarray(jj, dtype=np.int64)
    sizes64 = np.ascontiguousarray(sizes, dtype=np.int64)
    assert uf.parent.dtype == np.int64 and uf.rank.dtype == np.int8
    out_i = np.empty(m, dtype=np.int64)
    out_j = np.empty(m, dtype=np.int64)
    out_d = np.empty(m, dtype=np.float64)
    ok = np.empty(m, dtype=np.uint8)
    kept = fn(csr.flat.ctypes.data, csr.offs.ctypes.data, ii64.ctypes.data,
              jj64.ctypes.data, m, sizes64.ctypes.data,
              ctypes.c_double(threshold), kmer_size, int(is_containment),
              uf.parent.ctypes.data, uf.rank.ctypes.data, out_i.ctypes.data,
              out_j.ctypes.data, out_d.ctypes.data, ok.ctypes.data,
              os.cpu_count() or 1)
    return out_i[:kept], out_j[:kept], out_d[:kept], ok.astype(bool)


# Source: rabbittclust_tpu/ops/cluster_fast.py::_gated_verify_block
def _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                        is_containment, kept_i, kept_j, kept_d,
                        verify_chunk=65536, max_rounds=48):
    """Round-structured exact verification of one candidate block.

    A pair whose endpoints are already connected cannot change the
    single-linkage partition, so the pairs are verified in Boruvka-like
    rounds: ONE candidate per live (root_i, root_j) component pair (round 1:
    one per row) is verified exactly, the passes are merged, and the rest
    are gated again.  Verifications drop from O(#candidates) to roughly
    O(N + #failed candidates) while the partition stays exactly the
    single-linkage one.  After ``max_rounds`` the remainder falls back to
    bulk chunked verification, bounding the worst case."""
    pi, pj = ii, jj
    rounds = 0
    while len(pi):
        roots = uf.roots_array()
        ri = roots[pi]
        rj = roots[pj]
        alive = ri != rj
        pi, pj, ri, rj = pi[alive], pj[alive], ri[alive], rj[alive]
        if len(pi) == 0:
            break
        rounds += 1
        if rounds == 1:
            # bootstrap: one candidate per row connects most rows to their
            # component in a single batch
            _, sel = np.unique(pi, return_index=True)
        elif rounds <= max_rounds:
            # first occurrence per unordered live root pair
            lo = np.minimum(ri, rj)
            hi = np.maximum(ri, rj)
            key = lo * np.int64(len(uf.parent) + 1) + hi
            _, sel = np.unique(key, return_index=True)
        else:  # fallback: bulk-verify a chunk (degenerate candidate sets)
            sel = np.arange(min(len(pi), verify_chunk))
        ci, cj = pi[sel], pj[sel]
        common = csr.count_common(ci, cj)
        if is_containment:
            d = aaf_distance(common, sizes[ci], sizes[cj], kmer_size)
        else:
            d = mash_distance(common, sizes[ci], sizes[cj], kmer_size)
        ok = (common > 0) & (d <= threshold)
        for a, b, dd in zip(ci[ok].tolist(), cj[ok].tolist(),
                            d[ok].tolist()):
            if not uf.connected(a, b):
                uf.merge(a, b)
                kept_i.append(a)
                kept_j.append(b)
                kept_d.append(dd)
        keep = np.ones(len(pi), dtype=bool)
        keep[sel] = False  # verified pairs (pass or fail) leave the pool
        pi, pj = pi[keep], pj[keep]

"""Exact threshold clustering without an MST (counterpart of
``rabbittclust_tpu/ops/cluster_fast.py``): the bitmap filter on the GPU
plus the shared union-find-gated exact verify on the host.

``threshold_clusters_device`` picks the engine by size, as the JAX package
does: the stream engine (``ops/bitmap.py::candidate_pair_blocks``, K1, host
verify of every pulled block) at or below 16,384 genomes, the resident-mask
label-propagation engine (``ops/labelprop.py``, K1 + K2) above.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..host import (
    CsrSketches,
    UnionFind,
    _gated_verify_block,
    clusters_from_forest,
    cut_forest,
    kruskal,
    labels_from_clusters,
    native_intra_mst,
    native_mst,
)
from .bitmap import candidate_pair_blocks

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
    sizes = np.array([len(h) for h in hashes], dtype=np.int64)
    uf = UnionFind(n)
    kept_i: List[int] = []
    kept_j: List[int] = []
    kept_d: List[float] = []
    csr = CsrSketches(hashes)  # built once, reused by every block
    for ii, jj in candidate_pair_blocks(
            hashes, threshold, kmer_size, is_containment=is_containment,
            bits=bits, row_block=row_block, device=device):
        _gated_verify_block(uf, csr, sizes, ii, jj, threshold, kmer_size,
                            is_containment, kept_i, kept_j, kept_d,
                            verify_chunk)
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
    if res is None:  # no native library: keep the fast BFS order
        return clusters, False
    edges, has_cross = res
    if has_cross:
        full = native_mst(hashes, threshold, kmer_size, is_containment, 0,
                          False, 1)
        if full is None:
            return clusters, False
        edges = full[0]
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

"""clust-mst with the extra sketch types (WMH / HLL / OMH) on the GPU
(counterpart of ``rabbittclust_tpu/workflows_extra.py``).

``--sketch-func WMH|HLL|OMH`` runs genome sketching (the NumPy sketchers
of ``sketch/extra.py``), dense all-pairs distances (K8's positional token
matches on the card for WMH and OMH, float64 on the host for HLL), Kruskal
over all N(N - 1)/2 edges, the forest cut and the standard ``.cluster``
output (reference modifyMST semantics, MST.cpp:843-907).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .io.fasta import read_fasta, read_file_list
from .sketch.base import SketchSet
from .sketch.extra import (
    HLL_SKETCH_BIT,
    HllSketch,
    OmhSketch,
    hll_sketch,
    omh_sketch,
    wminhash_sketch_multi,
)
from .sketch.murmur3 import murmur3_batch_canonical


# Source: rabbittclust_tpu/workflows_extra.py::log
def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# Source: rabbittclust_tpu/workflows_extra.py::_hll_sketch_multi
def _hll_sketch_multi(seqs, k):
    """HLL over a multi-sequence genome (pooled k-mer hashes)."""
    parts = [murmur3_batch_canonical(s, k) for s in seqs]
    h = np.concatenate(parts) if parts else np.empty(0, np.uint64)
    base = hll_sketch(b"", k)
    m = len(base.registers)
    regs = np.zeros(m, dtype=np.uint8)
    if len(h):
        h = np.unique(h)
        bits = HLL_SKETCH_BIT
        bucket = (h >> np.uint64(64 - bits)).astype(np.int64)
        rest = (h << np.uint64(bits)) | np.uint64((1 << bits) - 1)
        lz = np.zeros(len(h), dtype=np.uint8)
        v = rest.copy()
        for shift in (32, 16, 8, 4, 2, 1):
            top = v >> np.uint64(64 - shift)
            zero = top == 0
            lz[zero] += shift
            v = np.where(zero, v << np.uint64(shift), v)
        np.maximum.at(regs, bucket, (lz + 1).astype(np.uint8))
    return HllSketch(regs, HLL_SKETCH_BIT)


# Source: rabbittclust_tpu/workflows_extra.py::_omh_sketch_multi
def _omh_sketch_multi(seqs, k):
    """OMH over a multi-sequence genome: occurrences in per-sequence
    concatenation order (matches the reference's sequential ->update)."""
    parts = [murmur3_batch_canonical(s, k) for s in seqs]
    base = np.concatenate(parts) if parts else np.empty(0, np.uint64)
    # reuse omh_sketch's salting/selection on the pooled hash stream
    fake = omh_sketch(b"", k)
    l, m = fake.vectors.shape[1], fake.vectors.shape[0]
    out = np.zeros((m, l), dtype=np.uint64)
    if len(base) < l:
        return OmhSketch(out)
    for rep in range(m):
        salted = base * np.uint64(0x9E3779B97F4A7C15) + np.uint64(
            42 + rep * 2654435761)
        salted = (salted ^ (salted >> np.uint64(31))) * np.uint64(
            0xBF58476D1CE4E5B9)
        order = np.argsort(salted, kind="stable")[:l]
        order.sort()
        out[rep] = base[order]
    return OmhSketch(out)


# Source: rabbittclust_tpu/workflows_extra.py::sketch_genomes_extra
def sketch_genomes_extra(input_file: str, sketch_by_file: bool, min_len: int,
                         kmer_size: int, func: str
                         ) -> Tuple[SketchSet, List]:
    """Ingest genomes (by-file list or by-sequence FASTA) and build one
    extra-type sketch per genome.  Returns (metadata SketchSet, sketches)."""
    ss = SketchSet(f"extra-{func.lower()}", None, sketch_by_file, True)
    sketches: List = []

    def add(file_name, name, comment, seqs):
        total = sum(len(s) for s in seqs)
        if total < min_len or not seqs:
            return
        if func == "WMH":
            sk = wminhash_sketch_multi(seqs, kmer_size)
        elif func == "HLL":
            sk = _hll_sketch_multi(seqs, kmer_size)
        elif func == "OMH":
            sk = _omh_sketch_multi(seqs, kmer_size)
        else:
            raise ValueError(f"unknown sketch function: {func}")
        ss.append_genome(file_name=file_name, name=name or "noName",
                         comment=comment or "noName", seq0_len=len(seqs[0]),
                         total_len=total, num_seqs=len(seqs),
                         hashes=np.empty(0, dtype=np.uint64))
        sketches.append(sk)

    if sketch_by_file:
        for fpath in read_file_list(input_file):
            records = list(read_fasta(fpath))
            if not records:
                continue
            name, comment, _ = records[0]
            add(fpath, name, comment, [s for _, _, s in records])
    else:
        for name, comment, seq in read_fasta(input_file):
            add(input_file, name, comment, [seq])
    return ss, sketches


# Source: rabbittclust_tpu/workflows_extra.py::pair_distances_extra
def pair_distances_extra(sketches: List, func: str, kmer_size: int,
                         device: Optional[torch.device] = None
                         ) -> np.ndarray:
    """The (N, N) float64 distances: WMH and OMH through K8 on ``device``
    (``None`` requires CUDA; the CPU runs the plain version), HLL on the
    host."""
    from .ops.extra_pairs import (
        hll_pair_distances,
        omh_pair_distances,
        wmh_pair_distances,
    )
    if func == "WMH":
        return wmh_pair_distances(sketches, device=device)
    if func == "HLL":
        return hll_pair_distances(sketches, kmer_size)
    if func == "OMH":
        return omh_pair_distances(sketches, kmer_size, device=device)
    raise ValueError(f"unknown sketch function: {func}")


# Source: rabbittclust_tpu/workflows_extra.py::clust_from_genomes_extra
def clust_from_genomes_extra(input_file: str, output_file: str,
                             sketch_by_file: bool, func: str, kmer_size: int,
                             threshold: float, min_len: int,
                             device: Optional[torch.device] = None,
                             stats: Optional[dict] = None) -> None:
    """clust-mst with an extra sketch type: dense all-pairs (modifyMST
    semantics, MST.cpp:843-907) -> MST -> forest cut -> .cluster output.
    ``stats``, when given, receives ``sketch_s``, ``pairs_s`` and
    ``kruskal_s`` (host seconds; ``pairs_s`` includes K8's launch and
    its pull)."""
    from .cluster.mst import clusters_from_forest, cut_forest, kruskal
    from .state.cluster_io import write_cluster_file

    t0 = time.perf_counter()
    ss, sketches = sketch_genomes_extra(input_file, sketch_by_file, min_len,
                                        kmer_size, func)
    t1 = time.perf_counter()
    n = len(ss)
    log(f"-----the size of sketches (genomes) is: {n} [{func}]")
    if n == 0:
        raise ValueError(
            f"no genomes above min length {min_len} in {input_file}")
    dmat = pair_distances_extra(sketches, func, kmer_size, device=device)
    t2 = time.perf_counter()
    iu, ju = np.triu_indices(n, k=1)
    mst = kruskal((iu.astype(np.int64), ju.astype(np.int64),
                   dmat[iu, ju].astype(np.float64)), n)
    t3 = time.perf_counter()
    clusters = clusters_from_forest(cut_forest(mst, threshold), n)
    write_cluster_file(output_file, clusters, ss, threshold)
    log(f"-----write the cluster result into: {output_file}")
    log(f"-----the number of clusters is: {len(clusters)}")
    if stats is not None:
        stats.update(sketch_s=t1 - t0, pairs_s=t2 - t1, kruskal_s=t3 - t2)

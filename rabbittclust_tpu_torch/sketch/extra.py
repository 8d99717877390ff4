"""Additional sketch types: weighted MinHash, HyperLogLog, OrderMinHash.

Parity items for the reference's RabbitSketch capability surface
(SURVEY.md §2.9: `Sketch::WMinHash`, `Sketch::HyperLogLog`,
`Sketch::OrderMinHash`).  In the reference these are latent — reachable only
through the legacy modifyMST path with sketchFunc hard-wired to "MinHash"
(main.cpp:73) — and the implementing submodule is absent from the snapshot,
so these are standard-algorithm implementations, not bit-replications:

  * WMinHash — Ioffe's Consistent Weighted Sampling over the k-mer count
    histogram (reference constants: sketch size 50, window 20;
    common.hpp:23-24); similarity = fraction of matching (index, y) samples.
  * HyperLogLog — classic HLL (2^10 registers, common.hpp:25) with
    inclusion-exclusion Jaccard -> Mash distance.
  * OrderMinHash — Marçais et al. (Bioinformatics 2019): l lowest-hash
    k-mer occurrences per sketch with their relative order; similarity
    compares ordered tuples (edit-distance-correlated).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .murmur3 import murmur3_batch_canonical

WMH_SKETCH_SIZE = 50   # reference common.hpp:23
HLL_SKETCH_BIT = 10    # reference common.hpp:25


# ---------------------------------------------------------------------------
# Weighted MinHash (ICWS)
# ---------------------------------------------------------------------------

# Source: rabbittclust_tpu/sketch/extra.py::WMinHashSketch
@dataclass
class WMinHashSketch:
    idx: np.ndarray   # (S,) sampled feature index
    y: np.ndarray     # (S,) quantized y values (discretized log weight)


# Source: rabbittclust_tpu/sketch/extra.py::_multi_hashes
def _multi_hashes(seqs, k: int) -> np.ndarray:
    """Canonical k-mer hashes over a list of sequences, per-sequence (k-mers
    never span sequence boundaries — matches the reference's per-sequence
    ->update() accumulation in by-file mode, SketchInfo.cpp:896-938)."""
    parts = [murmur3_batch_canonical(s, k) for s in seqs]
    return (np.concatenate(parts) if parts
            else np.empty(0, dtype=np.uint64))


# Source: rabbittclust_tpu/sketch/extra.py::wminhash_sketch_multi
def wminhash_sketch_multi(seqs, k: int = 21,
                          sketch_size: int = WMH_SKETCH_SIZE,
                          seed: int = 42) -> "WMinHashSketch":
    """ICWS weighted MinHash over the pooled k-mer histogram of a multi-
    sequence genome."""
    h = _multi_hashes(seqs, k)
    feats, weights = np.unique(h, return_counts=True)
    return _wminhash_from_histogram(feats, weights, sketch_size, seed)


# Source: rabbittclust_tpu/sketch/extra.py::_wminhash_from_histogram
def _wminhash_from_histogram(feats: np.ndarray, weights: np.ndarray,
                             sketch_size: int, seed: int) -> WMinHashSketch:
    if len(feats) == 0:
        return WMinHashSketch(np.zeros(sketch_size, np.uint64),
                              np.zeros(sketch_size, np.int64))
    w = weights.astype(np.float64)
    idx_out = np.empty(sketch_size, dtype=np.uint64)
    y_out = np.empty(sketch_size, dtype=np.int64)
    logw = np.log(w)
    for s in range(sketch_size):
        # per-(sample, feature) pseudo-random draws keyed by feature hash
        rng = np.random.default_rng(
            np.uint64(seed * 1_000_003 + s))
        # derive per-feature streams deterministically from feature value
        mix = (feats * np.uint64(0x9E3779B97F4A7C15)
               + np.uint64(s * 2654435761 + seed))
        u = ((mix >> np.uint64(11)).astype(np.float64) + 0.5) / (2 ** 53)
        mix2 = mix * np.uint64(0xBF58476D1CE4E5B9) + np.uint64(1)
        u2 = ((mix2 >> np.uint64(11)).astype(np.float64) + 0.5) / (2 ** 53)
        mix3 = mix * np.uint64(0x94D049BB133111EB) + np.uint64(2)
        u3 = ((mix3 >> np.uint64(11)).astype(np.float64) + 0.5) / (2 ** 53)
        # gamma(2,1) via sum of two exponentials
        r = -np.log(u) - np.log(u2)
        c = -np.log(u3) - np.log(
            (((mix3 >> np.uint64(12)) | np.uint64(1)).astype(np.float64))
            / (2 ** 52))
        beta = u2  # uniform(0,1)
        t = np.floor(logw / r + beta)
        ylog = r * (t - beta)
        a = c - ylog - r
        kmin = int(np.argmin(a))
        idx_out[s] = feats[kmin]
        y_out[s] = int(t[kmin])
    return WMinHashSketch(idx_out, y_out)


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------

# Source: rabbittclust_tpu/sketch/extra.py::HllSketch
@dataclass
class HllSketch:
    registers: np.ndarray  # (2^bits,) uint8
    bits: int = HLL_SKETCH_BIT


# Source: rabbittclust_tpu/sketch/extra.py::hll_sketch
def hll_sketch(seq: bytes, k: int = 21,
               bits: int = HLL_SKETCH_BIT) -> HllSketch:
    h = murmur3_batch_canonical(seq, k)
    m = 1 << bits
    regs = np.zeros(m, dtype=np.uint8)
    if len(h):
        h = np.unique(h)
        bucket = (h >> np.uint64(64 - bits)).astype(np.int64)
        rest = (h << np.uint64(bits)) | np.uint64((1 << bits) - 1)
        # rank = leading zeros of remaining bits + 1
        lz = np.zeros(len(h), dtype=np.uint8)
        v = rest.copy()
        for shift in (32, 16, 8, 4, 2, 1):
            top = v >> np.uint64(64 - shift)
            zero = top == 0
            lz[zero] += shift
            v = np.where(zero, v << np.uint64(shift), v)
        rank = (lz + 1).astype(np.uint8)
        np.maximum.at(regs, bucket, rank)
    return HllSketch(regs, bits)


# Source: rabbittclust_tpu/sketch/extra.py::hll_cardinality
def hll_cardinality(s: HllSketch) -> float:
    m = len(s.registers)
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-s.registers.astype(np.float64)))
    zeros = int(np.sum(s.registers == 0))
    if est <= 2.5 * m and zeros:
        est = m * math.log(m / zeros)
    return float(est)


# Source: rabbittclust_tpu/sketch/extra.py::hll_distance
def hll_distance(a: HllSketch, b: HllSketch, kmer_size: int = 21) -> float:
    """Mash distance from HLL-estimated Jaccard (inclusion-exclusion)."""
    union = HllSketch(np.maximum(a.registers, b.registers), a.bits)
    cu = hll_cardinality(union)
    ca = hll_cardinality(a)
    cb = hll_cardinality(b)
    inter = max(ca + cb - cu, 0.0)
    j = inter / cu if cu > 0 else 0.0
    if j >= 1.0:
        return 0.0
    if j <= 0.0:
        return 1.0
    return min(-1.0 / kmer_size * math.log(2 * j / (1 + j)), 1.0)


# ---------------------------------------------------------------------------
# OrderMinHash
# ---------------------------------------------------------------------------

# Source: rabbittclust_tpu/sketch/extra.py::OmhSketch
@dataclass
class OmhSketch:
    vectors: np.ndarray   # (m, l) uint64 — m independent ordered sketches


# Source: rabbittclust_tpu/sketch/extra.py::omh_sketch
def omh_sketch(seq: bytes, k: int = 21, l: int = 3, m: int = 64,
               seed: int = 42) -> OmhSketch:
    """Order MinHash: for each of m hash functions, the l lowest-hash k-mer
    occurrences in sequence order."""
    base = murmur3_batch_canonical(seq, k)
    out = np.zeros((m, l), dtype=np.uint64)
    if len(base) < l:
        return OmhSketch(out)
    for rep in range(m):
        salted = base * np.uint64(0x9E3779B97F4A7C15) + np.uint64(
            seed + rep * 2654435761)
        salted = (salted ^ (salted >> np.uint64(31))) * np.uint64(
            0xBF58476D1CE4E5B9)
        order = np.argsort(salted, kind="stable")[:l]
        order.sort()  # sequence order of the selected occurrences
        out[rep] = base[order]
    return OmhSketch(out)

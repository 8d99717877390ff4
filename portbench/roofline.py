"""The card's peaks and the least time of each kernel's work.

A kernel's share of its roofline is its least time over its kernel time
from the profiler's trace.  The least time counts what the inputs need,
whatever implements it: each input byte read once, each output byte
written once, the operations at their unit's peak, and the larger of the
two bounds.  Shares are against these peaks at the card's full power
limit; ``run.py`` prints the card's limit beside every run.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, NVIDIA's data sheet: device memory bytes/s
HBM_BPS = 3.35e12
# single-bit tensor-core products (wgmma m64n256k256 .b1 .and.popc), two
# operations a bit multiply-add: measured on an H100 80GB HBM3 at 700 W
# (NVIDIA publishes no such rate); the port's chip_smoke.py phase 3b
B1_OPS = 15.649e15
# INT32 operations/s: 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock
INT32_OPS = 132 * 64 * 1.98e9
# bits of the signatures K1 compares (the MST-free engines' width)
K1_BITS = 8192


def least_time(n_bytes: float, n_ops: float, ops_rate: float) -> float:
    """Seconds: the larger of the bytes at HBM_BPS and the operations at
    ``ops_rate``."""
    return max(n_bytes / HBM_BPS, n_ops / ops_rate)


def k1_need(pairs: float, genomes: int, bits: int = K1_BITS):
    """(bytes, operations) of K1's filter over ``pairs`` pairs among
    ``genomes`` genomes: every pair's shared-bit count (a bit
    multiply-add is two operations), each signature read once, one mask
    bit a pair written."""
    return genomes * bits / 8 + pairs / 8, 2.0 * pairs * bits


def shared_hash_matches(flat: np.ndarray) -> int:
    """Sum over pairs of genomes of their common hashes: each hash held by
    m genomes is m (m - 1) / 2 matches."""
    _, m = np.unique(flat, return_counts=True)
    m = m.astype(np.int64)
    return int((m * (m - 1) // 2).sum())


def k4_mask(n: int, entries: int, matches: int):
    """(bytes, operations) of K4's mask mode over all pairs of a corpus of
    n genomes holding ``entries`` 32-bit hashes: the hashes read once, one
    mask bit a pair written; one operation a match (a shared hash of a
    pair)."""
    return 4.0 * entries + n * (n - 1) / 2 / 8, float(matches)

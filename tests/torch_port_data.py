"""Seeded sketch corpora shared by the torch-port tests (numpy only, so the
JAX reference and the port see the same inputs)."""

from __future__ import annotations

import numpy as np


def clustered_sketches(n=220, s=150, n_clusters=10, seed=13,
                       dtype=np.uint32, keep=0.75):
    """n sorted unique hash arrays in ``n_clusters`` planted clusters (the
    recipe of tests/test_mst_compact_pull.py and bench.py)."""
    rng = np.random.default_rng(seed)
    hi = 2 ** 31 if dtype == np.uint32 else 2 ** 60
    bases = [np.unique(rng.integers(0, hi, size=s).astype(dtype))
             for _ in range(n_clusters)]
    out = []
    for i in range(n):
        b = bases[i % n_clusters]
        kept = b[rng.random(len(b)) < keep]
        extra = np.unique(rng.integers(0, hi, size=s - len(kept)).astype(
            dtype))
        out.append(np.unique(np.concatenate([kept, extra])))
    return out


def containment_sketches(n=100, seed=5):
    """Subsets of one base of varied size plus noise (AAF containment)."""
    rng = np.random.default_rng(seed)
    base = np.unique(rng.integers(0, 2 ** 31, size=500).astype(np.uint32))
    out = []
    for _ in range(n):
        take = int(rng.integers(80, 500))
        sub = rng.choice(base, size=take, replace=False)
        noise = np.unique(rng.integers(0, 2 ** 31, size=take // 5).astype(
            np.uint32))
        out.append(np.unique(np.concatenate([sub, noise])))
    return out

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


def clear_list(packs, rng, n_pairs=40, pad_to=256):
    """(4, pad_to) int32 clear list (tile, row, byte, bit value) over set
    bits of the packed masks ``packs`` (T, rb, rb // 8) uint8: every set
    bit of ``n_pairs`` random nonzero bytes, half of them bytes with
    several set bits, one entry per bit, so (tile, row, byte) targets
    repeat; then no-op padding (bit value 0)."""
    t, r, b = np.nonzero(packs)
    nbits = np.unpackbits(packs[t, r, b][:, None], axis=1).sum(1)
    multi = rng.permutation(np.flatnonzero(nbits >= 2))[:n_pairs // 2]
    single = rng.permutation(np.flatnonzero(nbits == 1))
    order = np.concatenate([multi, single[:n_pairs - len(multi)]])
    ents = []
    for q in order:
        byte = int(packs[t[q], r[q], b[q]])
        for k in range(8):
            if byte >> k & 1:
                ents.append((t[q], r[q], b[q], 1 << k))
    ents = ents[:pad_to]
    out = np.zeros((4, pad_to), dtype=np.int32)
    if ents:
        out[:, :len(ents)] = np.array(ents, dtype=np.int32).T
    return out

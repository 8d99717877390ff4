"""Vectorized MurmurHash3 (x64_128 lower half / x86_32) over k-mer windows
(the port's copy of ``rabbittclust_tpu/sketch/murmur3.py``): the k-mer
hashes of the WMH, HLL and OMH sketchers, in NumPy (Mash convention,
seed 42).
"""

from __future__ import annotations

import numpy as np

_COMP = np.zeros(256, dtype=np.uint8)
for a, b in zip(b"ACGTacgtNn", b"TGCATGCANN"):
    _COMP[a] = b
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32

_VALID = np.zeros(256, dtype=bool)
for c in b"ACGTacgt":
    _VALID[c] = True


# Source: rabbittclust_tpu/sketch/murmur3.py::_rotl64
def _rotl64(x, r):
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


# Source: rabbittclust_tpu/sketch/murmur3.py::_fmix64
def _fmix64(k):
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xFF51AFD7ED558CCD)
    k ^= k >> np.uint64(33)
    k *= np.uint64(0xC4CEB9FE1A85EC53)
    k ^= k >> np.uint64(33)
    return k


# Source: rabbittclust_tpu/sketch/murmur3.py::murmur3_x64_128_lower
def murmur3_x64_128_lower(rows: np.ndarray, seed: int = 42) -> np.ndarray:
    """Lower 64 bits of murmur3_x64_128 for each row of a (n, L) uint8 array."""
    n, L = rows.shape
    c1 = np.uint64(0x87C37B91114253D5)
    c2 = np.uint64(0x4CF5AD432745937F)
    h1 = np.full(n, seed, dtype=np.uint64)
    h2 = np.full(n, seed, dtype=np.uint64)
    nblocks = L // 16
    pad = np.zeros((n, 16), dtype=np.uint8)
    with np.errstate(over="ignore"):
        for b in range(nblocks):
            blk = rows[:, b * 16:(b + 1) * 16]
            k1 = blk[:, 0:8].copy().view("<u8").ravel().astype(np.uint64)
            k2 = blk[:, 8:16].copy().view("<u8").ravel().astype(np.uint64)
            k1 = _rotl64(k1 * c1, 31) * c2
            h1 ^= k1
            h1 = (_rotl64(h1, 27) + h2) * np.uint64(5) + np.uint64(0x52DCE729)
            k2 = _rotl64(k2 * c2, 33) * c1
            h2 ^= k2
            h2 = (_rotl64(h2, 31) + h1) * np.uint64(5) + np.uint64(0x38495AB5)
        tail_len = L & 15
        if tail_len:
            tail = pad.copy()
            tail[:, :tail_len] = rows[:, nblocks * 16:]
            k1 = tail[:, 0:8].copy().view("<u8").ravel().astype(np.uint64)
            k2 = tail[:, 8:16].copy().view("<u8").ravel().astype(np.uint64)
            if tail_len > 8:
                k2 = _rotl64(k2 * c2, 33) * c1
                h2 ^= k2
            else:
                k2 = np.uint64(0)
            k1 = _rotl64(k1 * c1, 31) * c2
            h1 ^= k1
        h1 ^= np.uint64(L)
        h2 ^= np.uint64(L)
        h1 += h2
        h2 += h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 += h2
    return h1


# Source: rabbittclust_tpu/sketch/murmur3.py::_rotl32
def _rotl32(x, r):
    r = np.uint32(r)
    return (x << r) | (x >> (np.uint32(32) - r))


# Source: rabbittclust_tpu/sketch/murmur3.py::murmur3_x86_32
def murmur3_x86_32(rows: np.ndarray, seed: int = 42) -> np.ndarray:
    n, L = rows.shape
    c1 = np.uint32(0xCC9E2D51)
    c2 = np.uint32(0x1B873593)
    h1 = np.full(n, seed, dtype=np.uint32)
    nblocks = L // 4
    with np.errstate(over="ignore"):
        for b in range(nblocks):
            k1 = rows[:, b * 4:(b + 1) * 4].copy().view("<u4").ravel().astype(np.uint32)
            k1 = _rotl32(k1 * c1, 15) * c2
            h1 ^= k1
            h1 = _rotl32(h1, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        tail_len = L & 3
        if tail_len:
            tail = np.zeros((n, 4), dtype=np.uint8)
            tail[:, :tail_len] = rows[:, nblocks * 4:]
            k1 = tail.view("<u4").ravel().astype(np.uint32)
            k1 = _rotl32(k1 * c1, 15) * c2
            h1 ^= k1
        h1 ^= np.uint32(L)
        h1 ^= h1 >> np.uint32(16)
        h1 *= np.uint32(0x85EBCA6B)
        h1 ^= h1 >> np.uint32(13)
        h1 *= np.uint32(0xC2B2AE35)
        h1 ^= h1 >> np.uint32(16)
    return h1


# Source: rabbittclust_tpu/sketch/murmur3.py::murmur3_batch_canonical
def murmur3_batch_canonical(seq: bytes, k: int, seed: int = 42) -> np.ndarray:
    """Hashes of all valid canonical k-mers of ``seq`` (Mash semantics)."""
    raw = np.frombuffer(seq, dtype=np.uint8)
    if len(raw) < k:
        return np.empty(0, dtype=np.uint64)
    from numpy.lib.stride_tricks import sliding_window_view
    up = _UPPER[raw]
    win = sliding_window_view(up, k)
    valid = _VALID[win].all(axis=1)
    fwd = win[valid]
    if len(fwd) == 0:
        return np.empty(0, dtype=np.uint64)
    rc = _COMP[fwd[:, ::-1]]
    # canonical: memcmp-smaller row
    use_fwd = np.ones(len(fwd), dtype=bool)
    undecided = np.ones(len(fwd), dtype=bool)
    for col in range(k):
        f = fwd[:, col]
        r = rc[:, col]
        lt = undecided & (f < r)
        gt = undecided & (f > r)
        use_fwd[gt] = False
        undecided &= ~(lt | gt)
        if not undecided.any():
            break
    can = np.where(use_fwd[:, None], fwd, rc).astype(np.uint8)
    can = np.ascontiguousarray(can)
    if k > 16:
        return murmur3_x64_128_lower(can, seed)
    return murmur3_x86_32(can, seed).astype(np.uint64)

"""Seeded sketch corpora shared by the torch-port tests (numpy only, so the
JAX reference and the port see the same inputs)."""

from __future__ import annotations

import os

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


def shared_sketches(n=200, s=150, seed=5, dtype=np.uint32, n_common=6):
    """``clustered_sketches`` in two planted clusters kept at 0.95, each
    genome also holding the same ``n_common`` hashes: values repeated
    across most genomes of a group of 128, and some across all of it
    (long runs of one value in a bucket of the grouped compact form)."""
    hashes = clustered_sketches(n=n, s=s, n_clusters=2, seed=seed,
                                dtype=dtype, keep=0.95)
    common = np.random.default_rng(seed + 1).integers(
        0, 2 ** 60 if dtype == np.uint64 else 2 ** 31,
        size=n_common).astype(dtype)
    return [np.unique(np.concatenate([h, common])) for h in hashes]


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


def kssd_window(seed, k, n_pos):
    """One dispatch window of base codes (n_pos + k - 1, int8): random
    bases with 2 % invalid codes, two record separators (k - 1 invalid
    codes), a low-complexity run of a 3-base unit, and the -1 padding of a
    final window over its last 700 positions."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 4, n_pos + k - 1).astype(np.int8)
    w[rng.random(len(w)) < 0.02] = -1
    for at in (n_pos // 3, 2 * n_pos // 3 + 5):
        w[at:at + k - 1] = -1
    run = n_pos // 2
    w[run:run + 600] = np.resize(np.array([0, 2, 3], np.int8), 600)
    w[n_pos - 700:] = -1
    return w


def dense_keep_table(dim_end, half_subk, seed):
    """A KSSD shuffle table that keeps most dimensions (ranks mostly below
    ``dim_end``, some negative), so nearly every valid window is kept."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-dim_end // 8, dim_end + dim_end // 4,
                     1 << (4 * half_subk))
    return t.astype(np.int32)


def planted_tokens(n, s, c, seed):
    """(n, s, c) uint32 WMH/OMH-style token planes in clusters of 7: a
    genome copies each sample of its cluster's base with its own
    probability in [0, 1], so pairs share from 0 to s samples; rows 0 and
    1 agree in word 0 only, rows 2 and 3 are equal."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 2 ** 32, size=(-(-n // 7), s, c),
                         dtype=np.uint64).astype(np.uint32)
    tok = rng.integers(0, 2 ** 32, size=(n, s, c),
                       dtype=np.uint64).astype(np.uint32)
    for i in range(n):
        take = rng.random(s) < rng.random()
        tok[i, take] = bases[i // 7, take]
    if n >= 4:
        tok[1, :, 0] = tok[0, :, 0]
        tok[3] = tok[2]
    return tok


def write_scale_genomes(folder, n_clusters=20, per_cluster=20, length=25000,
                        mutation=0.012, seed=99, length_jitter=5000):
    """The 400-genome scale corpus's parameters (tests/test_torch_scale.py)
    drawn with numpy: ``n_clusters`` random ancestors, each copied
    ``per_cluster`` times with point mutations at ``mutation``, each copy
    cut to ``length - U[0, length_jitter]``.  One FASTA file a genome;
    returns the path of their list."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    files = []
    for c in range(n_clusters):
        base = rng.integers(0, 4, length, dtype=np.uint8)
        for m in range(per_cluster):
            g = base.copy()
            hit = rng.random(length) < mutation
            g[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
            cut = length - int(rng.integers(0, length_jitter + 1))
            files.append(os.path.join(folder, f"g{c}_{m}.fna"))
            with open(files[-1], "wb") as f:
                f.write(f">genome_{c}_{m} cluster{c}\n".encode())
                seq = acgt[g[:cut]].tobytes()
                for k in range(0, cut, 80):
                    f.write(seq[k:k + 80] + b"\n")
    lst = os.path.join(folder, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(files) + "\n")
    return lst


def stats_division_operands(n=1 << 20, seed=0):
    """(a, b) float32 operands of the stats epilogue's two divisions
    (``ops/intersect.py::stats_epilogue``) over their ranges: common /
    max(denom, 1) with sizes s0, s1 in [1, 2^31) (log-uniform) and common
    in [0, min(s0, s1)] (uniform, log-uniform, 0, 1 and the minimum), and
    denom = s0 + s1 - common in float32; then 2j / (1 + j) with those
    quotients j in (0, 1) and j over [2^-32, 1): log-uniform, the 1,024
    floats above 2^-32 and the 1,024 below 1."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    s = np.exp2(rng.uniform(0, 31, (2, n))).astype(np.int64).clip(
        1, 2 ** 31 - 1)
    mn = s.min(0)
    c = (rng.uniform(0, 1, n) * (mn + 1)).astype(np.int64)
    q = n // 8
    c[:q] = np.exp2(rng.uniform(0, np.log2(mn[:q]))).astype(np.int64)
    c[q:2 * q], c[2 * q:3 * q], c[3 * q:3 * q + 64] = mn[q:2 * q], 1, 0
    c = c.clip(0, mn)
    common = c.astype(f32)
    a1 = common
    b1 = np.maximum((s[0].astype(f32) + s[1].astype(f32)) - common, f32(1))
    j = a1 / b1
    tiny = np.float32(2.0 ** -32)
    j = np.concatenate([
        j[(j > 0) & (j < 1)],
        np.exp2(rng.uniform(-32, 0, n)).astype(f32).clip(
            tiny, np.nextafter(f32(1), f32(0))),
        tiny + np.arange(1024, dtype=f32) * np.spacing(tiny),
        f32(1) - np.arange(1, 1025, dtype=f32) * np.spacing(f32(0.5))])
    return (np.concatenate([a1, f32(2) * j]),
            np.concatenate([b1, f32(1) + j]))

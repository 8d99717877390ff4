"""The one traffic generator: planted species of KSSD sketches, read from a
traffic file (``traffic/<name>.json``), the deployment's genome count and
a seed.

A traffic file gives ``genomes_per_species``, ``zipf_exponent``,
``base_hashes``, ``keep`` ([low, high]), ``sketch_size`` ([low, high]),
``planted_pairs`` and ``bases_per_hash``; ``sources`` and ``assumed`` say
where each comes from and are not read.

- The genomes fall into round(genomes / genomes_per_species) species whose
  sizes follow a Zipf law over the species' ranks, at least one genome
  each; they are the same for every seed.
- Each species has ``base_hashes`` distinct hashes below 2^31 - 1 and a
  keep probability; the keeps are a fixed low-discrepancy sequence over
  [low, high] by rank (the golden-ratio sequence), so every seed has the
  same (size, keep) pairs and the same work, in another order.
- A member draws its sketch size uniformly from ``sketch_size``; each of
  its first slots holds the species' hash with the keep probability and a
  random hash otherwise, and the slots past ``base_hashes`` are random.  A
  hash drawn twice in one genome is kept once.
- ``planted_pairs`` pairs of two genomes each share exactly c hashes at
  sizes (s_a, s_b) whose Mash distance lies nearest the threshold,
  half just above it and half at or below it, found by search.
- The genome order is a random permutation.

Everything is drawn on ``device`` by one ``torch.Generator`` in a few
large calls; the same seed and device type give the same corpus.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .reference import mash_distance

HASH_PAD = (1 << 31) - 1  # hashes lie below it; it pads a row
GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
# members drawn per call; fixed, since the stream of draws depends on it
CHUNK = 65536


@dataclass
class Corpus:
    flat: np.ndarray      # uint32 hashes, genome after genome, ascending
    offsets: np.ndarray   # (n + 1,) int64
    group: np.ndarray     # (n,) int64: species, then planted pair
    lengths: np.ndarray   # (n,) int64 genome lengths shown in .cluster rows
    planted: np.ndarray   # (pairs, 2) genome ids of the planted pairs
    planted_d: np.ndarray  # (pairs,) their Mash distances

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def hashes(self):
        """One array per genome, as a presketched load gives them."""
        return [a.copy() for a in np.split(self.flat, self.offsets[1:-1])]


def species_sizes(genomes: int, species: int, exponent: float) -> np.ndarray:
    """Zipf sizes over ranks 1..species summing to ``genomes``, each >= 1:
    floors of the law, then the remainder to the largest fractions."""
    w = 1.0 / np.arange(1, species + 1, dtype=np.float64) ** exponent
    raw = genomes * w / w.sum()
    sizes = np.maximum(np.floor(raw).astype(np.int64), 1)
    diff = int(genomes - sizes.sum())
    if diff > 0:
        sizes[np.argsort(-(raw - np.floor(raw)), kind="stable")[:diff]] += 1
    for r in range(-diff):  # over-full only when the floor of 1 binds
        sizes[r % species] -= 1
    sizes = np.sort(sizes)[::-1].copy()  # by rank again
    if sizes.min() < 1 or sizes.sum() != genomes:
        raise ValueError(f"{genomes} genomes cannot fill {species} species")
    return sizes


def species_keeps(species: int, low: float, high: float) -> np.ndarray:
    """Keep probability of each species rank: the golden-ratio sequence."""
    r = np.arange(1, species + 1, dtype=np.float64)
    return low + (high - low) * np.mod(r * GOLDEN, 1.0)


def near_threshold_pairs(count: int, size_low: int, size_high: int,
                         threshold: float, kmer: int):
    """(s_a, s_b, c, D) of ``count`` pairs whose sizes lie in
    [size_low, size_high]: the sums S nearest the threshold from above
    (count // 2 of them) and at or below it (the rest), each at its c."""
    x = math.exp(-threshold * kmer)
    jmin = x / (2.0 - x)
    above, below = [], []
    for s in range(2 * size_low, 2 * size_high + 1):
        c0 = int(jmin * s / (1.0 + jmin))
        c = np.arange(max(c0 - 2, 1), c0 + 3)
        d = mash_distance(c, s - c, c, kmer)
        for ci, di in zip(c.tolist(), d.tolist()):
            (above if di > threshold else below).append(
                (abs(di - threshold), s, ci, di))
    above.sort()
    below.sort()
    out = []
    for pool, k in ((above, count // 2), (below, count - count // 2)):
        seen = set()
        for _, s, c, d in pool:
            if len(seen) == k:
                break
            if s not in seen:
                seen.add(s)
                out.append((s // 2, s - s // 2, c, d))
    return out


def _distinct(g, m, device):
    """``m`` distinct hashes in random order."""
    u = torch.empty(0, dtype=torch.int32, device=device)
    while len(u) < m:
        u = torch.unique(torch.cat([u, torch.randint(
            0, HASH_PAD, (2 * m,), generator=g, device=device,
            dtype=torch.int32)]))
    return u[torch.randperm(len(u), generator=g, device=device)[:m]]


def _dedup(rows: torch.Tensor) -> torch.Tensor:
    """Rows ascending, each hash once, pads last."""
    rows = rows.sort(1).values
    rows[:, 1:].masked_fill_(rows[:, 1:] == rows[:, :-1], HASH_PAD)
    return rows.sort(1).values


def species_count(genomes: int, per_species: float) -> int:
    return max(1, int(round(genomes / per_species)))


def generate(traffic: dict, genomes: int, threshold: float, kmer: int,
             seed: int, device: torch.device) -> Corpus:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    n = int(genomes)
    pairs = near_threshold_pairs(int(traffic["planted_pairs"]),
                                 *traffic["sketch_size"], threshold, kmer)
    sizes = species_sizes(
        n - 2 * len(pairs),
        species_count(n, float(traffic["genomes_per_species"])),
        float(traffic["zipf_exponent"]))
    n_sp = len(sizes)
    keeps = torch.as_tensor(species_keeps(n_sp, *traffic["keep"]),
                            dtype=torch.float32, device=device)
    b = int(traffic["base_hashes"])
    lo, hi = traffic["sketch_size"]
    width = max(b, hi)
    base = torch.randint(0, HASH_PAD, (n_sp, b), generator=g, device=device,
                         dtype=torch.int32)
    species_of = torch.repeat_interleave(
        torch.arange(n_sp, device=device), torch.as_tensor(sizes,
                                                           device=device))
    cols = torch.arange(width, device=device)
    rows = []
    for c0 in range(0, len(species_of), CHUNK):
        sp = species_of[c0:c0 + CHUNK]
        size = torch.randint(lo, hi + 1, (len(sp),), generator=g,
                             device=device)
        keep = torch.rand((len(sp), b), generator=g, device=device) < \
            keeps[sp, None]
        vals = torch.randint(0, HASH_PAD, (len(sp), width), generator=g,
                             device=device, dtype=torch.int32)
        vals[:, :b] = torch.where(keep, base[sp], vals[:, :b])
        vals.masked_fill_(cols[None, :] >= size[:, None], HASH_PAD)
        rows.append(_dedup(vals))
    groups = [species_of]
    for k, (s_a, s_b, c, _) in enumerate(pairs):
        u = _distinct(g, s_a + s_b - c, device)
        pair = torch.full((2, width), HASH_PAD, dtype=torch.int32,
                          device=device)
        pair[0, :s_a] = u[:s_a]
        pair[1, :c] = u[:c]
        pair[1, c:s_b] = u[s_a:]
        rows.append(_dedup(pair))
        groups.append(torch.full((2,), n_sp + k, device=device))
    rows = torch.cat(rows)
    group = torch.cat(groups)
    perm = torch.randperm(n, generator=g, device=device)
    rows, group = rows[perm], group[perm]
    inv = torch.argsort(perm)
    m = len(species_of)
    planted = torch.stack([inv[m::2], inv[m + 1::2]], 1)
    valid = rows != HASH_PAD
    counts = valid.sum(1).cpu().numpy().astype(np.int64)
    flat = rows[valid].cpu().numpy().view(np.uint32)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return Corpus(flat=flat, offsets=offsets,
                  group=group.cpu().numpy().astype(np.int64),
                  lengths=counts * int(traffic["bases_per_hash"]),
                  planted=planted.cpu().numpy().astype(np.int64),
                  planted_d=np.array([p[3] for p in pairs]))

"""The traffic generator: determinism, the laws it draws from, and the
planted pairs at the threshold."""

import json
import math
import os

import numpy as np
import pytest

from portbench import corpus, harness, reference
from portbench.tests.helpers import (SEED, brute_counts, small_corpus,
                                     small_traffic)


def test_same_seed_same_corpus_other_seed_other():
    a, b = small_corpus(), small_corpus()
    c = small_corpus(seed=SEED + 1)
    for field in ("flat", "offsets", "group", "planted"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    assert not np.array_equal(a.flat[:1000], c.flat[:1000])


@pytest.mark.parametrize("genomes,species", [(290000, 60004),
                                             (16384, 3390)])
def test_species_count_is_the_genomes_per_species_of_the_source(
        genomes, species):
    with open(os.path.join(harness.HERE, "traffic", "refseq.json")) as f:
        per = json.load(f)["genomes_per_species"]
    assert per == pytest.approx(317542 / 65703, abs=5e-4)  # GTDB R207
    assert corpus.species_count(genomes, per) == species


def test_species_sizes_follow_zipf():
    s = corpus.species_sizes(289984, 60004, 1.0)
    assert s.sum() == 289984 and s.min() >= 1
    assert 24900 <= s[0] <= 25100  # 289,984 / H(60,004)
    assert np.all(np.diff(s) <= 0)
    for r in (2, 3, 10, 100):  # s_1 / s_r ~ r
        assert abs(s[0] / s[r - 1] - r) <= 0.01 * r + 0.5
    assert np.all(s[26000:] == 1)  # the tail of singletons
    # every seed has the same sizes: they depend on the counts alone
    a, b = small_corpus(), small_corpus(seed=SEED + 7)
    assert np.array_equal(np.bincount(a.group), np.bincount(b.group))


def test_keeps_lie_in_range_and_are_fixed():
    lo, hi = small_traffic()["keep"]
    k = corpus.species_keeps(20000, lo, hi)
    assert k.min() >= lo and k.max() <= hi
    assert np.array_equal(k, corpus.species_keeps(20000, lo, hi))
    # spread over the range: each tenth holds about a tenth of them
    hist = np.histogram(k, bins=10, range=(lo, hi))[0]
    assert hist.min() >= 1900 and hist.max() <= 2100
    # members lie at D = -2 ln(keep) / 22: strain to species level
    d = [-2 * math.log(x) / 22 for x in (hi, lo)]
    assert 0.004 < d[0] < 0.005 and 0.029 < d[1] < 0.030


def test_sketch_sizes_sorted_and_in_range():
    c = small_corpus()
    assert c.sizes.max() <= 1040 and c.sizes.min() >= 1040 - 80 - 5
    for h in c.hashes():
        assert np.all(np.diff(h.astype(np.int64)) > 0)
        assert h.max() < corpus.HASH_PAD
    assert np.array_equal(c.lengths, c.sizes * 4096)


def test_genome_order_is_shuffled():
    c = small_corpus(genomes=400, species=20)
    same_next = np.mean(c.group[1:] == c.group[:-1])
    assert same_next < 0.3  # in species order it would be ~0.95
    assert not np.all(np.diff(c.group) >= 0)


def test_planted_pairs_sit_on_both_sides_of_the_threshold():
    c = small_corpus()
    d = c.planted_d
    assert np.sum(d > 0.05) == 4 and np.sum(d <= 0.05) == 4
    assert np.all(np.abs(d - 0.05) < 2e-5)
    counts = brute_counts(c)
    s = c.sizes
    for (a, b), want in zip(c.planted, d):
        got = reference.mash_distance(counts[a, b], s[a], s[b], 22)
        assert got == want
        assert c.group[a] == c.group[b]
        assert np.sum(c.group == c.group[a]) == 2

"""The plain reference against a brute-force all-pairs run, under the
generator's grouping and under groupings that follow nothing."""

import numpy as np
import pytest

from portbench import reference
from portbench.tests.helpers import CPU, brute_counts, small_corpus


def brute(c, counts, precision="float64"):
    """(partition labels, sorted graph keys, their weights, sorted MST
    weights) by Kruskal over every pair."""
    n, s = c.n, c.sizes
    ii, jj = np.nonzero(np.triu(counts, 1) > 0)
    dt = np.float32 if precision == "float32" else np.float64
    d = reference.mash_distance(counts[ii, jj], s[ii], s[jj], 22, dt)
    parent = np.arange(n)

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    for a, b in zip(ii[d <= dt(0.05)], jj[d <= dt(0.05)]):
        ra, rb = find(a), find(b)
        parent[max(ra, rb)] = min(ra, rb)
    labels = np.array([find(v) for v in range(n)])
    radio = reference.ratio_limit(0.05, 22)
    ok = np.maximum(s[ii], s[jj]) <= radio * np.minimum(s[ii], s[jj])
    ii, jj, d = ii[ok], jj[ok], d[ok].astype(np.float64)
    keys = ii * n + jj
    order = np.lexsort((keys, d))
    parent[:] = np.arange(n)
    w = []
    for k in order:
        ra, rb = find(ii[k]), find(jj[k])
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
            w.append(d[k])
    o = np.argsort(keys)
    return labels, keys[o], d[o], np.sort(w)


@pytest.fixture(scope="module")
def case():
    c = small_corpus(genomes=240, species=14)
    return c, brute_counts(c)


@pytest.mark.parametrize("grouping", ["species", "random", "one", "none"])
def test_reference_equals_brute_force(case, grouping):
    c, counts = case
    rng = np.random.default_rng(5)
    group = {"species": c.group,
             "random": rng.integers(0, 9, c.n),
             "one": np.zeros(c.n, dtype=np.int64),
             "none": np.arange(c.n)}[grouping]
    plan = reference.make_plan(c.flat, c.offsets, group, CPU)
    labels, keys, w, mst = brute(c, counts)
    assert np.array_equal(reference.partition(plan, 0.05, 22), labels)
    f = reference.forest(plan, 0.05, 22)
    assert np.array_equal(f.keys, keys)
    assert np.array_equal(f.weights, w)
    assert np.array_equal(f.mst_weights, mst)
    assert f.components == c.n - len(mst)
    assert np.array_equal(np.sort(f.weights[np.searchsorted(
        f.keys, f.mst_keys)]), mst)


def test_cross_pairs_count_every_shared_hash(case):
    c, counts = case
    group = np.random.default_rng(6).integers(0, 5, c.n)
    plan = reference.make_plan(c.flat, c.offsets, group, CPU)
    i, j, cnt = (t.numpy() for t in reference.cross_pairs(plan))
    ii, jj = np.nonzero(np.triu(counts, 1) > 0)
    cross = group[ii] != group[jj]
    assert np.array_equal(i * c.n + j, ii[cross] * c.n + jj[cross])
    assert np.array_equal(cnt, counts[ii[cross], jj[cross]])


def test_float32_control_matches_its_own_brute_force(case):
    c, counts = case
    plan = reference.make_plan(c.flat, c.offsets, c.group, CPU)
    labels, _, w, mst = brute(c, counts, "float32")
    assert np.array_equal(reference.partition(plan, 0.05, 22, "float32"),
                          labels)
    f = reference.forest(plan, 0.05, 22, "float32")
    assert np.array_equal(f.weights, w)
    assert np.array_equal(f.mst_weights, mst)


def test_bits_control_overcounts_and_merges_the_planted_pairs(case):
    c, _ = case
    plan = reference.make_plan(c.flat, c.offsets, c.group, CPU)
    exact = reference.partition(plan, 0.05, 22)
    bits = reference.partition(plan, 0.05, 22, "bits")
    for (a, b), d in zip(c.planted, c.planted_d):
        assert (exact[a] == exact[b]) == (d <= 0.05)
        assert bits[a] == bits[b]  # +~120 shared buckets by chance


def test_cmin_table_is_the_least_passing_count():
    t = reference.cmin_table(2100, 0.05, 22)
    assert np.all(np.diff(t[2:]) >= 0)
    for s in (1920, 2000, 2080):
        c = t[s]
        assert reference.mash_distance(c, s - c, c, 22) <= 0.05
        assert reference.mash_distance(c - 1, s - c + 1, c - 1, 22) > 0.05


def test_boruvka_on_ties_gives_a_spanning_forest():
    # a 4-cycle of equal weights and an isolated vertex
    keys = np.array([0 * 5 + 1, 1 * 5 + 2, 2 * 5 + 3, 0 * 5 + 3])
    sel = reference.boruvka(5, keys, np.ones(4), CPU)
    assert len(sel) == 3
    assert len(np.unique(keys[sel])) == 3


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import os
    for name in ("reference.py", "corpus.py", "judge.py", "control.py"):
        path = os.path.join(os.path.dirname(reference.__file__), name)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in (
                    "rabbittclust_tpu_torch", "rabbittclust_tpu", "jax",
                    "jaxlib"), (name, m)

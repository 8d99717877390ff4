"""The judgement's numbers on files that are right and on files with one
fault each."""

import numpy as np
import pytest

from portbench import control, judge, reference
from portbench.tests.helpers import CPU, small_corpus


@pytest.fixture(scope="module")
def ref():
    c = small_corpus(genomes=200, species=12)
    plan = reference.make_plan(c.flat, c.offsets, c.group, CPU)
    return (c, reference.partition(plan, 0.05, 22),
            reference.forest(plan, 0.05, 22))


def mst_rows(f):
    w = f.weights[np.searchsorted(f.keys, f.mst_keys)]
    return f.mst_keys // f.n, f.mst_keys % f.n, w.copy()


def test_right_files_read_zero(ref, tmp_path):
    c, labels, f = ref
    control.write_clusters(str(tmp_path / "a.cluster"), labels)
    control.write_mst(str(tmp_path / "run" / "edge.mst"), *mst_rows(f))
    got = judge.judge_outputs({"cluster": str(tmp_path / "a.cluster"),
                               "mst": str(tmp_path / "run" / "edge.mst")},
                              labels, f)
    assert got == {"genomes_gap": 0, "partition_gap": 0, "forest_gap": 0,
                   "edge_weight_gap": 0.0, "mst_weight_gap": 0.0}


def test_partition_faults(ref):
    _, labels, _ = ref
    ok = judge.partition_numbers(labels.copy(), 0, labels)
    assert ok == {"genomes_gap": 0, "partition_gap": 0}
    moved = labels.copy()
    big = np.bincount(labels).argmax()
    moved[np.flatnonzero(labels == big)[0]] = labels.max() + 1
    assert judge.partition_numbers(moved, 0, labels)["partition_gap"] > 0
    merged = labels.copy()
    merged[merged == merged[0]] = merged[-1]
    assert judge.partition_numbers(merged, 0, labels)["partition_gap"] > 0
    missing = labels.copy()
    missing[:3] = -1
    assert judge.partition_numbers(missing, 1, labels)["genomes_gap"] == 4


def test_mst_faults(ref):
    _, _, f = ref
    i, j, w = mst_rows(f)
    assert judge.mst_numbers((i, j, w), f)["forest_gap"] == 0
    w2 = w.copy()
    w2[0] += 1e-9
    got = judge.mst_numbers((i, j, w2), f)
    assert got["edge_weight_gap"] > 0 and got["mst_weight_gap"] > 0
    # a row that is no edge of the graph
    nb = judge.mst_numbers((np.r_[i, 0], np.r_[j, 0], np.r_[w, 0.0]), f)
    assert nb["forest_gap"] >= 2
    # one edge twice closes a cycle
    cy = judge.mst_numbers((np.r_[i, i[:1]], np.r_[j, j[:1]],
                            np.r_[w, w[:1]]), f)
    assert cy["forest_gap"] == 2
    # one edge left out
    short = judge.mst_numbers((i[1:], j[1:], w[1:]), f)
    assert short["forest_gap"] == 1 and short["mst_weight_gap"] == 1.0


def test_missing_and_repeated_rows(ref, tmp_path):
    _, labels, _ = ref
    path = str(tmp_path / "x.cluster")
    control.write_clusters(path, labels)
    lines = open(path).read().splitlines(keepends=True)
    rows = [k for k, s in enumerate(lines) if s.startswith("\t")]
    lines.append(lines[rows[0]])  # a genome twice
    del lines[rows[1]]           # a genome left out
    open(path, "w").writelines(lines)
    lab, bad = judge.read_clusters(path, len(labels))
    assert bad == 1 and (lab < 0).sum() == 1


def test_jobs_left_out_count_as_failed(ref, tmp_path):
    _, labels, _ = ref
    path = str(tmp_path / "y.cluster")
    control.write_clusters(path, labels)
    limits = {"partition_gap": 0}
    worst, failed = judge.judge_jobs([{"cluster": path}, None,
                                      {"cluster": path}], limits, labels)
    assert failed == 1 and worst["partition_gap"] == len(labels)
    worst, failed = judge.judge_jobs([{"cluster": path}] * 2, limits,
                                     labels)
    assert failed == 0 and worst["partition_gap"] == 0


def test_numbers_fold_the_parts():
    ok = {"genomes_gap": 0, "partition_gap": 0, "forest_gap": 0,
          "edge_weight_gap": 2e-9, "mst_weight_gap": 1e-9}
    assert judge.numbers(ok) == {"partition_gap": 0, "mst_gap": 2e-9}
    assert judge.numbers(dict(ok, genomes_gap=3))["partition_gap"] == 3
    assert judge.numbers(dict(ok, forest_gap=1))["mst_gap"] == 1.0

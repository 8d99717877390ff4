"""The mesh ring engine's exact MST against the benchmark's plain reference
on the CPU: a ``refseq`` corpus from ``portbench.corpus`` goes through
``workflows.compute_kssd_clusters`` as ``clust-mst --fast --device`` with
``edge.mst`` saved (the ``kssd-mst-mesh4`` configuration, the harness's
``Program``), ``mesh_devices`` giving it k CPU shards and ``RTC_MESH``
left at ``auto``, so the job takes the exact ring as it does on a host of
k cards.  ``portbench.judge`` holds its ``.cluster`` and ``edge.mst`` to
``portbench.reference``; the reference's own float32 distances, put in
the program's place, fail the same judgement."""

import json
import os

import pytest
import torch

from portbench import control, corpus, harness, judge, reference
from portbench.tests.helpers import SEED, small_traffic
from rabbittclust_tpu_torch import workflows

CPU = torch.device("cpu")
CONFIG = os.path.join(harness.HERE, "configs", "kssd-mst-mesh4.json")


def config(n):
    with open(CONFIG) as f:
        return dict(json.load(f), genomes=n)


def refseq_corpus(n):
    """The ``refseq`` traffic's shape at ``n`` genomes: its genomes per
    species, Zipf sizes, keeps and sketch sizes."""
    traffic = small_traffic(genomes=n, species=round(n / 4.833))
    return corpus.generate(traffic, n, 0.05, reference.kssd_kmer(21), SEED,
                           CPU)


def judged(cfg, c, files):
    """The numbers compared for ``correct``, of one job's files."""
    plan = reference.make_plan(c.flat, c.offsets, c.group, CPU)
    labels = reference.partition(plan, 0.05, reference.kssd_kmer(21))
    forest = reference.forest(plan, 0.05, reference.kssd_kmer(21))
    worst, failed = judge.judge_jobs([files], cfg["limits"], labels, forest)
    return worst, failed


@pytest.mark.parametrize("shards,n", [(2, 768), (4, 768), (4, 767)])
def test_mesh_job_meets_the_reference(shards, n, tmp_path, monkeypatch,
                                      capsys):
    monkeypatch.delenv("RTC_MESH", raising=False)
    monkeypatch.setattr(workflows, "mesh_devices",
                        lambda device: [device] * shards)
    cfg, c = config(n), refseq_corpus(n)
    program = harness.Program(cfg, c, CPU, str(tmp_path))
    rec = program.job()
    assert (f"using the {shards}-device mesh ring engine (exact)"
            in capsys.readouterr().err)
    counters = rec["stats"]["counters"]
    assert counters["mesh.cards"] == shards
    assert counters["mesh.candidates"] == counters["mst.kruskal_edges"] > n
    worst, failed = judged(cfg, c, program.files)
    assert failed == 0
    assert worst["partition_gap"] == 0
    assert worst["mst_gap"] <= cfg["limits"]["mst_gap"]


def test_float32_distances_fail_the_judgement(tmp_path):
    cfg, c = config(768), refseq_corpus(768)
    program = control.ControlProgram(cfg, c, CPU, str(tmp_path), "float32")
    program.job()
    worst, failed = judged(cfg, c, program.files)
    assert failed == 1
    assert worst["mst_gap"] > cfg["limits"]["mst_gap"]

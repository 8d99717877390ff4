"""The ``-t 1`` scale comparisons on 400 genomes: the port's CLIs on the
CPU (``main(argv, device=cpu)``) against the JAX package's CLIs in the same
process, on the corpora of ``tests/test_golden_scale.py`` (20 clusters x 20
genomes of 25 kb at 1.2 % mutations, seed 99; the varied corpus cut to
20-25 kb, the tie corpus all of one length).

At ``-t 1`` both packages replicate the reference's serial tie order
(libstdc++ std::sort through the shared native library), so the outputs
are byte-equal even where distances tie en masse:
(a) ``clust-mst --fast -l --device -t 1`` through the dense engine's plain
    versions: the ``.cluster`` file and the run folder's sketches and
    ``edge.mst``;
(b) ``clust-greedy --fast -l --device -t 1``: the ``.cluster`` file;
(c) ``clust-mst --fast -l --device -e -t 1`` at 2048-bit signatures and
    row blocks of 256: the ``.cluster`` file and the arm taken (certified
    intra-cluster replay, or the full serial engine's fallback);
(d) the device partition at row blocks of 256 against the JAX host MST's
    cut.
"""

import os

import pytest
import torch

from rabbittclust_tpu.cli.clust_greedy import main as jax_greedy_main
from rabbittclust_tpu.cli.clust_mst import main as jax_mst_main
from rabbittclust_tpu_torch.cli.clust_greedy import main as port_greedy_main
from rabbittclust_tpu_torch.cli.clust_mst import main as port_mst_main

CPU = torch.device("cpu")
MAINS = {"mst": (jax_mst_main, port_mst_main),
         "greedy": (jax_greedy_main, port_greedy_main)}


# Source: tests/test_golden_scale.py::varied_genomes
@pytest.fixture(scope="module")
def varied_genomes(tmp_path_factory):
    """20 clusters x 20 genomes, lengths 20-25 kb (varied sketch sizes:
    distances mostly unique, a few exact ties)."""
    from tests.helpers import make_clustered_genomes
    tmp = tmp_path_factory.mktemp("torch_scale_varied")
    return make_clustered_genomes(tmp, n_clusters=20, per_cluster=20,
                                  length=25000, mutation=0.012, seed=99,
                                  length_jitter=5000)


# Source: tests/test_golden_scale.py::tie_genomes
@pytest.fixture(scope="module")
def tie_genomes(tmp_path_factory):
    """20 clusters x 20 genomes of one 25 kb length: equal sketch sizes
    everywhere; at the default drlevel 3 the ~6-hash sketches give mass
    exact-d ties, d = 0.0 among them."""
    from tests.helpers import make_clustered_genomes
    tmp = tmp_path_factory.mktemp("torch_scale_tie")
    return make_clustered_genomes(tmp, n_clusters=20, per_cluster=20,
                                  length=25000, mutation=0.012, seed=99)


def _run_folder(d):
    runs = [p for p in os.listdir(d) if os.path.isdir(os.path.join(d, p))]
    assert len(runs) == 1, runs
    return os.path.join(d, runs[0])


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _run_both(tool, argv, tmp_path, monkeypatch):
    """Runs argv through the JAX CLI and the port's (on the CPU), each in a
    working directory of its own; returns {side: working directory}."""
    monkeypatch.setenv("RTC_MESH", "0")
    dirs = {}
    for side, fn in zip(("jax", "port"), MAINS[tool]):
        wd = tmp_path / side
        wd.mkdir()
        monkeypatch.chdir(wd)
        kw = {"device": CPU} if side == "port" else {}
        assert fn(argv + ["-o", str(wd / "o.cluster")], **kw) == 0
        dirs[side] = str(wd)
    return dirs


def _args(fx, extra):
    return ["--fast", "-l", "-i", fx.list_file, "-d", "0.05", "--device",
            "-t", "1", *extra]


MST_ARMS = {"varied-dr2": ("varied", ["--drlevel", "2"]),
            "tie-dr2": ("tie", ["--drlevel", "2"]),
            "tie-dr3": ("tie", [])}


@pytest.mark.parametrize("arm", list(MST_ARMS))
def test_scale_mst_byte_equal(arm, varied_genomes, tie_genomes, tmp_path,
                              monkeypatch):
    """(a) The full MST through the dense engine; ``tie-dr3`` is the
    harshest tie regime (mass d = 0.0 among ~6-hash sketches)."""
    corpus, extra = MST_ARMS[arm]
    fx = varied_genomes if corpus == "varied" else tie_genomes
    monkeypatch.setenv("RTC_MST_CLUSTERS_FAST", "0")
    d = _run_both("mst", _args(fx, extra), tmp_path, monkeypatch)
    assert _same_bytes(os.path.join(d["jax"], "o.cluster"),
                       os.path.join(d["port"], "o.cluster"))
    jf, pf = _run_folder(d["jax"]), _run_folder(d["port"])
    for f in ("kssd.hash.sketch", "kssd.info.sketch", "edge.mst"):
        assert _same_bytes(os.path.join(jf, f), os.path.join(pf, f)), f
    with open(os.path.join(d["port"], "o.cluster")) as f:
        assert f.read().count("the cluster") >= 20


@pytest.mark.parametrize("corpus", ["varied", "tie"])
def test_scale_greedy_byte_equal(corpus, varied_genomes, tie_genomes,
                                 tmp_path, monkeypatch):
    """(b) On the tie corpus the greedy size sort is all ties."""
    fx = varied_genomes if corpus == "varied" else tie_genomes
    d = _run_both("greedy", _args(fx, ["--drlevel", "2"]), tmp_path,
                  monkeypatch)
    assert _same_bytes(os.path.join(d["jax"], "o.cluster"),
                       os.path.join(d["port"], "o.cluster"))


class _ArmSpy:
    """Wraps ``threshold_clusters_device_exact_order`` where a workflow
    looks it up and records the ``certified`` flag of each call."""

    def __init__(self, monkeypatch, module):
        self.flags = []
        real = module.threshold_clusters_device_exact_order

        def spy(*args, **kwargs):
            clusters, certified = real(*args, **kwargs)
            self.flags.append(certified)
            return clusters, certified
        monkeypatch.setattr(module, "threshold_clusters_device_exact_order",
                            spy)


FAST_ARMS = {"varied-tuned-k": ("varied", ["--drlevel", "2"]),
             "varied-k21": ("varied", ["--drlevel", "2", "-k", "21"]),
             "tie-k21": ("tie", ["--drlevel", "2", "-k", "21"])}


@pytest.mark.parametrize("arm", list(FAST_ARMS))
def test_scale_mst_device_fast_byte_equal(arm, varied_genomes, tie_genomes,
                                          tmp_path, monkeypatch):
    """(c) ``-e -t 1``, the MST-free engine, takes the JAX CLI's arm.  At
    these genome sizes (at most 25 kb) both CLIs replace ``-k 21`` by the
    reference's tuned k 14, at which hashes cross clusters: every arm here
    falls back to the full serial engine (the certified arm is held below
    and at 5,000 genomes)."""
    from rabbittclust_tpu.ops import cluster_fast as jax_cf
    from rabbittclust_tpu_torch import workflows as port_wf
    corpus, extra = FAST_ARMS[arm]
    fx = varied_genomes if corpus == "varied" else tie_genomes
    monkeypatch.delenv("RTC_MST_CLUSTERS_FAST", raising=False)
    monkeypatch.setenv("RTC_PULL_MODE", "mask")
    monkeypatch.setenv("RTC_CLUSTER_BITS", "2048")
    monkeypatch.setenv("RTC_CLUSTER_RB", "256")
    jax_arm = _ArmSpy(monkeypatch, jax_cf)
    port_arm = _ArmSpy(monkeypatch, port_wf)
    d = _run_both("mst", _args(fx, extra + ["-e"]), tmp_path, monkeypatch)
    assert _same_bytes(os.path.join(d["jax"], "o.cluster"),
                       os.path.join(d["port"], "o.cluster"))
    assert len(port_arm.flags) == 1
    assert port_arm.flags == jax_arm.flags


@pytest.mark.parametrize("corpus", ["varied", "tie"])
def test_scale_exact_order_certified_arm(corpus, varied_genomes,
                                         tie_genomes):
    """(c) The certified arm at k 21 (no hash crosses clusters): the
    port's ``threshold_clusters_device_exact_order`` at 2048 bits and row
    blocks of 256 gives the JAX function's clusters in its member order,
    and both certify."""
    from rabbittclust_tpu.ops.cluster_fast import (
        threshold_clusters_device_exact_order as jax_exact_order)
    from rabbittclust_tpu.sketch.kssd import (
        sketch_files_kssd as jax_sketch)
    from rabbittclust_tpu_torch.ops.cluster_fast import (
        threshold_clusters_device_exact_order)
    from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd
    fx = varied_genomes if corpus == "varied" else tie_genomes
    ss, p = sketch_files_kssd(fx.files, 10000, 21, 2, 1)
    jss, _ = jax_sketch(fx.files, 10000, 21, 2, 1)
    got = threshold_clusters_device_exact_order(
        ss.hashes, 0.05, p.kmer_size, bits=2048, row_block=256, device=CPU)
    want = jax_exact_order(jss.hashes, 0.05, p.kmer_size, bits=2048,
                           row_block=256)
    assert got == want
    assert got[1] is True and len(got[0]) == 20


def test_scale_device_partition_matches_host(varied_genomes):
    """(d) The port's device partition (plain K1 and the stream engine at
    row blocks of 256) against the JAX host MST cut at 0.05."""
    from rabbittclust_tpu.cluster.mst import (
        clusters_from_forest, compute_mst, cut_forest)
    from rabbittclust_tpu.sketch.kssd import (
        sketch_files_kssd as jax_sketch)
    from rabbittclust_tpu_torch.ops.cluster_fast import (
        threshold_clusters_device)
    from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd

    ss, p = sketch_files_kssd(varied_genomes.files, min_len=10000,
                              kmer_size=21, drlevel=2)
    jss, _ = jax_sketch(varied_genomes.files, min_len=10000, kmer_size=21,
                        drlevel=2)
    assert all((a == b).all() for a, b in zip(ss.hashes, jss.hashes))
    cd = threshold_clusters_device(ss.hashes, 0.05, p.kmer_size,
                                   row_block=256, device=CPU)
    res = compute_mst(jss.hashes, 0.05, p.kmer_size)
    ch = clusters_from_forest(cut_forest(res.mst, 0.05), len(jss))
    assert sorted(map(sorted, cd)) == sorted(map(sorted, ch))
    assert len(cd) >= 20


def test_scale_corpora_copy_the_golden_recipe(varied_genomes, tie_genomes):
    """The corpora are the golden scale test's: 400 genomes each, the tie
    corpus of one length, the varied one cut to 20-25 kb."""
    def lengths(fx):
        out = []
        for path in fx.files:
            with open(path) as f:
                out.append(sum(len(line.strip()) for line in f
                               if not line.startswith(">")))
        return out
    tie, varied = lengths(tie_genomes), lengths(varied_genomes)
    assert len(tie) == len(varied) == 400
    assert set(tie) == {25000}
    assert 20000 <= min(varied) < max(varied) <= 25000

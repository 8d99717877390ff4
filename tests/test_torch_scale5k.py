"""The ``-t 1`` scale comparison at 5,000 genomes: the port's
``clust-mst --fast -l --device -e -t 1`` on the CPU against the JAX CLI's
in the same process, on the corpus of ``tests/test_golden_scale5k.py``
(200 clusters x 25 genomes of 11 kb at 2 % mutations, drlevel 2).  Row
blocks of 512 put the block edges inside clusters, so the stream engine's
tiles and the serial replay's subSize = 8 cadence cross each other."""

import numpy as np
import pytest
import torch

from rabbittclust_tpu.cli.clust_mst import main as jax_mst_main
from rabbittclust_tpu_torch.cli.clust_mst import main as port_mst_main

CPU = torch.device("cpu")
N_CLUSTERS = 200
PER_CLUSTER = 25          # 5000 genomes
GENOME_LEN = 11000        # >= the 10k min-length filter
DRLEVEL = 2               # 1/256 reduction -> ~40 hashes per genome

_B = np.frombuffer(b"ACGT", dtype=np.uint8)


# Source: tests/test_golden_scale5k.py::corpus5k
@pytest.fixture(scope="module")
def corpus5k(tmp_path_factory):
    """5000 genomes, one file each, listed in input order, made with
    vectorized numpy from one seed."""
    tmp = tmp_path_factory.mktemp("torch_scale5k")
    rng = np.random.default_rng(20260820)
    files = []
    for c in range(N_CLUSTERS):
        base = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
        for m in range(PER_CLUSTER):
            g = base.copy()
            mut = rng.random(GENOME_LEN) < 0.02
            g[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
            seq = _B[g].tobytes()
            fp = tmp / f"g{c:03d}_{m:02d}.fna"
            with open(fp, "wb") as f:
                f.write(b">genome_%03d_%02d cluster%03d\n" % (c, m, c))
                for k in range(0, GENOME_LEN, 80):
                    f.write(seq[k:k + 80] + b"\n")
            files.append(str(fp))
    list_file = tmp / "list.txt"
    list_file.write_text("\n".join(files) + "\n")
    return str(list_file)


def test_mst_5k_device_fast_byte_equal(corpus5k, tmp_path, monkeypatch):
    """(e) ``-e --device -t 1 -k 21 --drlevel 2`` under
    ``RTC_CLUSTER_RB=512``: the ``.cluster`` files byte-equal and the same
    arm taken (certified replay or the full serial engine)."""
    from rabbittclust_tpu.ops import cluster_fast as jax_cf
    from rabbittclust_tpu_torch import workflows as port_wf
    flags = {"jax": [], "port": []}
    for side, module in (("jax", jax_cf), ("port", port_wf)):
        real = module.threshold_clusters_device_exact_order

        def spy(*args, _real=real, _side=side, **kwargs):
            clusters, certified = _real(*args, **kwargs)
            flags[_side].append(bool(certified))
            return clusters, certified
        monkeypatch.setattr(module, "threshold_clusters_device_exact_order",
                            spy)
    monkeypatch.setenv("RTC_MESH", "0")
    monkeypatch.setenv("RTC_PULL_MODE", "mask")
    monkeypatch.delenv("RTC_MST_CLUSTERS_FAST", raising=False)
    monkeypatch.setenv("RTC_CLUSTER_BITS", "2048")
    monkeypatch.setenv("RTC_CLUSTER_RB", "512")
    argv = ["--fast", "-l", "-i", corpus5k, "-d", "0.05", "--drlevel",
            str(DRLEVEL), "-k", "21", "-e", "--device", "-t", "1"]
    outs = {}
    for side, fn in (("jax", jax_mst_main), ("port", port_mst_main)):
        wd = tmp_path / side
        wd.mkdir()
        monkeypatch.chdir(wd)
        outs[side] = wd / "o.cluster"
        kw = {"device": CPU} if side == "port" else {}
        assert fn(argv + ["-o", str(outs[side])], **kw) == 0
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    assert len(flags["port"]) == 1 and flags["port"] == flags["jax"]
    assert outs["port"].read_text().count("the cluster") == N_CLUSTERS


@pytest.fixture(scope="module")
def sketches5k(corpus5k):
    """The corpus sketched at k 21, drlevel 2 by each package."""
    from rabbittclust_tpu.io.fasta import read_file_list as jax_list
    from rabbittclust_tpu.sketch.kssd import sketch_files_kssd as jax_sketch
    from rabbittclust_tpu_torch.io.fasta import read_file_list
    from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd
    ss, p = sketch_files_kssd(read_file_list(corpus5k), 10000, 21, DRLEVEL,
                              2)
    jss, _ = jax_sketch(jax_list(corpus5k), 10000, 21, DRLEVEL, 2)
    assert all((a == b).all() for a, b in zip(ss.hashes, jss.hashes))
    return ss.hashes, jss.hashes, p.kmer_size


def test_exact_order_5k_certified_arm(sketches5k):
    """(e) The certified arm at k 21, where no hash crosses clusters: the
    port's ``threshold_clusters_device_exact_order`` at 2048 bits and row
    blocks of 512 gives the JAX function's clusters in its member order."""
    from rabbittclust_tpu.ops.cluster_fast import (
        threshold_clusters_device_exact_order as jax_exact_order)
    from rabbittclust_tpu_torch.ops.cluster_fast import (
        threshold_clusters_device_exact_order)
    hashes, jhashes, k = sketches5k
    got = threshold_clusters_device_exact_order(
        hashes, 0.05, k, bits=2048, row_block=512, device=CPU)
    want = jax_exact_order(jhashes, 0.05, k, bits=2048, row_block=512)
    assert got == want
    assert got[1] is True and len(got[0]) == N_CLUSTERS


def test_labelprop_5k_partition_matches_host(sketches5k):
    """The port's LP engine in several panels (row blocks of 1024, four
    tiles a panel: 15 tiles in 4 panels) against the JAX host MST's cut."""
    from rabbittclust_tpu.cluster.mst import (
        clusters_from_forest, compute_mst, cut_forest)
    from rabbittclust_tpu_torch.ops import labelprop as lp
    hashes, jhashes, k = sketches5k
    res = compute_mst(jhashes, 0.05, k)
    want = clusters_from_forest(cut_forest(res.mst, 0.05), len(jhashes))
    got = lp.threshold_clusters_device_lp(hashes, 0.05, k, bits=2048,
                                          row_block=1024, panel_tiles=4,
                                          device=CPU)
    assert lp.LP_STATS["panels"] == 4
    assert sorted(map(sorted, got)) == sorted(map(sorted, want))

"""The port's DBSCAN and Louvain/Leiden engines on the CPU (the device
filter's plain versions) against the JAX package's: DBSCAN labels,
clusters and noise equal, similarity graphs equal edge for edge, and
community partitions equal, on the host path and on the device path under
both pulls (``RTC_PULL_MODE`` set alike on both sides)."""

import numpy as np
import pytest
import torch

from rabbittclust_tpu.cluster import dbscan as jax_db
from rabbittclust_tpu.cluster import leiden as jax_ld
from rabbittclust_tpu_torch.cluster import dbscan as port_db
from rabbittclust_tpu_torch.cluster import leiden as port_ld
from rabbittclust_tpu_torch.ops import bitmap as port_bm
from torch_port_data import clustered_sketches

CPU = torch.device("cpu")


def _corpus():
    """400 genomes: 10 planted clusters of 30, then 100 loners (DBSCAN
    noise at minPts 5), 32-bit hashes."""
    return (clustered_sketches(n=300, s=150, n_clusters=10) +
            clustered_sketches(n=100, s=150, n_clusters=100, seed=99))


ROUTES = [("host", None), ("device", "mask"), ("device", "idx")]
ROUTE_IDS = ["host", "device_mask", "device_idx"]


def _same_result(got, want):
    assert np.array_equal(got.labels, want.labels)
    assert got.clusters == want.clusters and got.noise == want.noise


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("knn_k,max_posting", [(0, 0), (3, 0), (0, 20)],
                         ids=["plain", "knn", "max_posting"])
def test_dbscan_cluster_equal_to_jax(route, knn_k, max_posting,
                                     monkeypatch):
    side, mode = route
    if mode:
        monkeypatch.setenv("RTC_PULL_MODE", mode)
    hashes = _corpus()
    use_device = side == "device"
    want = jax_db.dbscan_cluster(hashes, 0.05, 5, 21, knn_k=knn_k,
                                 max_posting=max_posting,
                                 use_device=use_device)
    port_bm.reset_launches()
    got = port_db.dbscan_cluster(hashes, 0.05, 5, 21, knn_k=knn_k,
                                 max_posting=max_posting,
                                 use_device=use_device, device=CPU)
    _same_result(got, want)
    assert got.num_noise >= 100
    if not (knn_k or max_posting):  # a 4-NN cap or trimmed keys split them
        assert got.num_clusters == 10
    # the plain versions stand in for the kernels on the CPU: no launch
    assert port_bm.LAUNCHES == {"filter_mask": 0, "mask_compact": 0}


@pytest.mark.parametrize("containment", [False, True], ids=["mash", "aaf"])
def test_minhash_dbscan_equal_to_jax(containment):
    hashes = [np.unique(h.astype(np.uint64) * np.uint64(2654435761))
              for h in _corpus()]
    want = jax_db.minhash_dbscan_cluster(hashes, 0.05, 4, 21,
                                         is_containment=containment)
    got = port_db.minhash_dbscan_cluster(hashes, 0.05, 4, 21,
                                         is_containment=containment)
    _same_result(got, want)
    assert got.num_clusters == 10


def test_trim_postings_equal_to_jax():
    hashes = _corpus()
    for got, want in zip(port_db.trim_postings(hashes, 20),
                         jax_db.trim_postings(hashes, 20)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("knn_k", [0, 500, 4])
def test_build_similarity_graph_equal_to_jax(route, knn_k, monkeypatch):
    """Edges, their order and weights equal; ``device`` is the
    RTC_LEIDEN_DEVICE=force route, the default one takes the native pairs
    under --device too (and matches the forced one once pruned).  Unpruned
    native pairs come in a thread-dependent order: that graph is compared
    in (from, to) order."""
    side, mode = route
    if mode:
        monkeypatch.setenv("RTC_PULL_MODE", mode)
        monkeypatch.setenv("RTC_LEIDEN_DEVICE", "force")
    hashes = _corpus()
    want = jax_ld.build_similarity_graph(hashes, 0.05, 21, knn_k=knn_k,
                                         use_device=side == "device")
    got = port_ld.build_similarity_graph(hashes, 0.05, 21, knn_k=knn_k,
                                         use_device=side == "device",
                                         device=CPU)
    if side == "host" and not knn_k:
        got, want = ([a[np.lexsort((g[1], g[0]))] for a in g]
                     for g in (got, want))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[0]) > 0
    if knn_k:
        native = port_ld.build_similarity_graph(hashes, 0.05, 21,
                                                knn_k=knn_k)
        assert all(np.array_equal(a, b) for a, b in zip(got, native))


def test_leiden_default_route_takes_native_pairs(monkeypatch, capsys):
    """Without RTC_LEIDEN_DEVICE=force, --device builds the graph from the
    native pairs and says so; the filter is never run."""
    monkeypatch.delenv("RTC_LEIDEN_DEVICE", raising=False)
    hashes = _corpus()
    called = []
    monkeypatch.setattr(port_bm, "candidate_pairs_threshold",
                        lambda *a, **k: called.append(1))
    got = port_ld.build_similarity_graph(hashes, 0.05, 21, knn_k=500,
                                         use_device=True, device=CPU)
    want = port_ld.build_similarity_graph(hashes, 0.05, 21, knn_k=500)
    assert not called
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert "routing --device to the native host engine" in \
        capsys.readouterr().err


@pytest.mark.parametrize("algo", ["leiden", "louvain", "edge_parallel"])
@pytest.mark.parametrize("route", [("host", None), ("device", "idx")],
                         ids=["host", "device_idx"])
def test_community_clusters_equal_to_jax(algo, route, monkeypatch):
    side, mode = route
    if mode:
        monkeypatch.setenv("RTC_PULL_MODE", mode)
        monkeypatch.setenv("RTC_LEIDEN_DEVICE", "force")
    hashes = _corpus()
    kw = dict(use_leiden=algo == "leiden", knn_k=500,
              use_device=side == "device",
              edge_parallel=algo == "edge_parallel")
    want = jax_ld.community_clusters(hashes, 0.05, 21, **kw)
    got = port_ld.community_clusters(hashes, 0.05, 21, device=CPU, **kw)
    assert got == want
    assert len(got) == 110  # 10 planted clusters and 100 loners


def test_graph_save_load_and_modularity_equal_to_jax(tmp_path):
    hashes = _corpus()
    graph = port_ld.build_similarity_graph(hashes, 0.05, 21)
    port_ld.save_graph(graph, len(hashes), str(tmp_path / "p.graph"))
    jax_ld.save_graph(graph, len(hashes), str(tmp_path / "j.graph"))
    assert (tmp_path / "p.graph").read_bytes() == \
        (tmp_path / "j.graph").read_bytes()
    n, back = port_ld.load_graph(str(tmp_path / "p.graph"))
    n_j, back_j = jax_ld.load_graph(str(tmp_path / "p.graph"))
    assert n == n_j == len(hashes)
    assert all(np.array_equal(a, b) for a, b in zip(back, back_j))
    mem = port_ld.leiden(n, back)
    assert np.array_equal(mem, jax_ld.leiden(n, back))
    assert port_ld.modularity(n, back, mem) == \
        jax_ld.modularity(n, back, mem)

"""The port's MST-free dispatcher on the CPU against the JAX package: both
engines give the JAX cluster lists, the -t 1 exact-order arm the JAX
arm's and the native serial engine's member order, and the settings read
from the environment are validated."""

import numpy as np
import pytest
import torch

from rabbittclust_tpu.cluster.mst import (
    clusters_from_forest,
    compute_mst,
    cut_forest,
)
from rabbittclust_tpu.ops import cluster_fast as jax_cf
from rabbittclust_tpu.utils.native import have_native
from rabbittclust_tpu_torch.ops import bitmap as port_bm
from rabbittclust_tpu_torch.ops import cluster_fast as port_cf
from rabbittclust_tpu_torch.ops import labelprop as port_lp
from torch_port_data import clustered_sketches, containment_sketches

CPU = torch.device("cpu")

CORPORA = {
    "32bit": (lambda: clustered_sketches(n=400, n_clusters=16), False),
    "64bit": (lambda: clustered_sketches(n=250, dtype=np.uint64), False),
    "containment": (lambda: containment_sketches(150), True),
}


@pytest.mark.parametrize("engine", ["stream", "lp"])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_threshold_clusters_equal_to_jax(corpus, engine, monkeypatch):
    """The engine forced through RTC_CLUSTER_ENGINE, as a user would; the
    JAX stream engine pinned to packed-mask pulls."""
    monkeypatch.setenv("RTC_CLUSTER_ENGINE", engine)
    monkeypatch.setenv("RTC_PULL_MODE", "mask")
    hashes, containment = CORPORA[corpus][0](), CORPORA[corpus][1]
    want = jax_cf.threshold_clusters_device(
        hashes, 0.05, 21, is_containment=containment, bits=2048,
        row_block=128)
    port_bm.reset_launches()
    port_lp.reset_lp_stats()
    got = port_cf.threshold_clusters_device(
        hashes, 0.05, 21, is_containment=containment, bits=2048,
        row_block=128, device=CPU)
    assert got == want
    assert (port_lp.LP_STATS["rounds"] > 0) == (engine == "lp")
    res = compute_mst(hashes, 0.05, 21, is_containment=containment)
    host = clusters_from_forest(cut_forest(res.mst, 0.05), len(hashes))
    assert sorted(map(sorted, got)) == sorted(map(sorted, host))


def _order_corpus(cross, seed=11):
    """tests/test_device_engine.py's exact-order corpora: disjoint
    per-cluster hash ranges (certified), or one range small enough that
    clusters share hashes (no certificate: the full serial engine)."""
    rng = np.random.default_rng(seed)
    hashes = []
    for c in range(12):
        lo = 0 if cross else c * (1 << 24)
        span = 1 << 14 if cross else 1 << 24
        base = np.unique((lo + rng.integers(0, span, size=60)).astype(
            np.uint32))
        for _ in range(15):
            keep = base[rng.random(len(base)) < 0.8]
            extra = (lo + rng.integers(0, span, size=8)).astype(np.uint32)
            hashes.append(np.unique(np.concatenate([keep, extra])))
    return hashes


@pytest.mark.parametrize("cross", [False, True],
                         ids=["certified", "cross_sharing"])
def test_exact_order_equals_jax_and_serial_engine(cross):
    if not have_native():
        pytest.skip("native library unavailable")
    hashes = _order_corpus(cross)
    n = len(hashes)
    want, want_cert = jax_cf.threshold_clusters_device_exact_order(
        hashes, 0.05, 21, bits=1024, row_block=128)
    got, cert = port_cf.threshold_clusters_device_exact_order(
        hashes, 0.05, 21, bits=1024, row_block=128, device=CPU)
    assert got == want and cert == want_cert
    serial = compute_mst(hashes, 0.05, 21, threads=1)
    assert got == clusters_from_forest(cut_forest(serial.mst, 0.05), n)
    assert cert == (not cross)


@pytest.mark.parametrize("env, match", [
    ({"RTC_CLUSTER_BITS": "32"}, "power of two >= 64"),
    ({"RTC_CLUSTER_BITS": "1000"}, "power of two >= 64"),
    ({"RTC_CLUSTER_RB": "48"}, "multiple of 32"),
    ({"RTC_CLUSTER_ENGINE": "dense"}, "cluster engine"),
], ids=["bits32", "bits1000", "rb48", "engine"])
def test_dispatcher_rejects_bad_settings(env, match, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    hashes = clustered_sketches(n=40, n_clusters=4)
    with pytest.raises(ValueError, match=match):
        port_cf.threshold_clusters_device(hashes, 0.05, 21, device=CPU)


def test_dispatcher_reads_bits_and_rb(monkeypatch):
    """RTC_CLUSTER_BITS / RTC_CLUSTER_RB reach the engine (and JAX reads
    them the same way)."""
    monkeypatch.setenv("RTC_CLUSTER_BITS", "128")
    monkeypatch.setenv("RTC_CLUSTER_RB", "64")
    monkeypatch.setenv("RTC_PULL_MODE", "mask")
    hashes = clustered_sketches(n=200, s=60, n_clusters=8, seed=9)
    want = jax_cf.threshold_clusters_device(hashes, 0.05, 21)
    got = port_cf.threshold_clusters_device(hashes, 0.05, 21, device=CPU)
    assert got == want

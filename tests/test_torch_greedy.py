"""The port's greedy engines on the CPU against the JAX package: the device
sweeps (``ops/greedy_device.py``, plain K1 under its ``greedy`` and
``minhash`` bounds), the batched route (plain K6, ``greedy_filter_plain``)
and the copied ``greedy_cluster_batched``, the native engines
(``cluster/greedy.py``), the density probe and the greedy orderings, on the
same seeded inputs.  Every comparison is exact: equal representative and
cluster lists, and K6's whole fused buffer."""

import numpy as np
import pytest
import torch

from rabbittclust_tpu.cluster import greedy as jax_greedy
from rabbittclust_tpu.ops import bitmap as jax_bm
from rabbittclust_tpu.ops import greedy_device as jax_gd
from rabbittclust_tpu.sketch import base as jax_base
from rabbittclust_tpu.workflows import _greedy_corpus_is_dense as jax_dense
from rabbittclust_tpu_torch.cluster import greedy as port_greedy
from rabbittclust_tpu_torch.ops import bitmap as port_bm
from rabbittclust_tpu_torch.ops import greedy_device as port_gd
from rabbittclust_tpu_torch.sketch import base as port_base
from rabbittclust_tpu_torch.workflows import \
    _greedy_corpus_is_dense as port_dense

CPU = torch.device("cpu")


def _same(want, got, what=None):
    assert want.representatives == got.representatives, what
    assert want.clusters == got.clusters, what


def _serial_corpus():
    """5 disjoint clusters of 4 near-copies (tests/test_device_engine.py:
    test_greedy_device_serial_mode_matches_serial)."""
    rng = np.random.default_rng(9)
    hashes = []
    for c in range(5):
        base = (rng.choice(1 << 22, size=500, replace=False).astype(np.uint32)
                + np.uint32(c << 23))
        for g in range(4):
            keep = rng.random(len(base)) > 0.03
            hashes.append(np.sort(base[keep]))
    return hashes


def _tie_corpus():
    """Exact duplicates and same-tail variants whose first shared hashes
    differ (tests/test_device_engine.py: test_greedy_device_serial_tie_exact)."""
    rng = np.random.default_rng(3)
    hashes = []
    for c in range(4):
        base = np.sort(rng.choice(1 << 20, size=300,
                                  replace=False).astype(np.uint32))
        for g in range(5):
            hashes.append(base.copy())
        for g in range(3):
            head = rng.choice(1 << 20, size=30, replace=False).astype(
                np.uint32)
            hashes.append(np.unique(np.r_[head, base[30:]]))
    return hashes


def test_greedy_device_serial_mode_matches_serial():
    """The single sweep replays the serial loop: equal to the JAX serial
    greedy and to the JAX device sweep (which holds at any batch size, so
    the port's sweep takes none)."""
    hashes = _serial_corpus()
    serial = jax_greedy.greedy_cluster(hashes, 0.05, 21)
    _same(serial, jax_gd.greedy_cluster_device(hashes, 0.05, 21))
    _same(serial, port_gd.greedy_cluster_device(hashes, 0.05, 21,
                                                device=CPU))


@pytest.mark.parametrize("cont", [False, True], ids=["mash", "aaf"])
def test_greedy_device_serial_tie_exact(cont):
    """Exact-similarity ties resolve to the serial host's first-touch
    (probe) order, not the smallest rep id."""
    hashes = _tie_corpus()
    serial = jax_greedy.greedy_cluster(hashes, 0.05, 21, is_containment=cont,
                                       backend="python")
    _same(serial, jax_gd.greedy_cluster_device(hashes, 0.05, 21,
                                               is_containment=cont))
    _same(serial, port_gd.greedy_cluster_device(
        hashes, 0.05, 21, is_containment=cont, device=CPU))
    # and the port's native engine agrees on the same tie corpus
    _same(serial, port_greedy.greedy_cluster(hashes, 0.05, 21,
                                             is_containment=cont))


def test_sweep_rows_streams_every_row_once():
    """_sweep_rows yields (j, candidates) for EVERY j = 1..n-1 in order
    (panel markers), the same rows and candidates as the JAX one, and the
    union of streamed candidates equals the pair set of the JAX and the
    port's non-streamed generators."""
    rng = np.random.default_rng(23)
    hashes = []
    for c in range(6):
        base = rng.choice(1 << 22, size=400, replace=False).astype(np.uint32)
        for g in range(5):
            keep = rng.random(len(base)) > 0.04
            hashes.append(np.unique(base[keep]))
    n = len(hashes)
    args = (hashes, 0.05, 21, False, 8192, 1024, "greedy")
    want = [(j, sorted(c.tolist())) for j, c in jax_gd._sweep_rows(*args)]
    got = [(j, sorted(c.tolist()))
           for j, c in port_gd._sweep_rows(*args, device=CPU)]
    assert got == want
    assert [j for j, _ in got] == list(range(1, n))
    streamed = set()
    for j, cand in got:
        assert all(i < j for i in cand)
        streamed.update((j, i) for i in cand)
    direct = set()
    for ii, jj in jax_bm.candidate_pair_blocks(hashes, 0.05, 21, bits=8192,
                                               row_block=1024,
                                               bound="greedy"):
        direct.update(zip(ii.tolist(), jj.tolist()))
    assert streamed == direct
    port_direct = set()
    for ii, jj in port_bm.candidate_pair_blocks(
            hashes, 0.05, 21, bits=8192, row_block=1024, bound="greedy",
            device=CPU):
        port_direct.update(zip(ii.tolist(), jj.tolist()))
    assert port_direct == direct


def test_sweep_rows_waits_for_the_panel_marker():
    """Rows are released only at their panel's marker, after every batch
    that holds a pair of theirs: with rb = 128 and 16 tiles a launch, a
    row's last pairs come from a later batch than its first."""
    rng = np.random.default_rng(5)
    base = np.unique(rng.integers(0, 1 << 30, size=300).astype(np.uint32))
    hashes = [np.unique(base[rng.random(len(base)) < 0.9])
              for _ in range(900)]
    args = (hashes, 0.05, 21, False, 256, 128, "greedy")
    want = [(j, sorted(c.tolist())) for j, c in jax_gd._sweep_rows(*args)]
    got = [(j, sorted(c.tolist()))
           for j, c in port_gd._sweep_rows(*args, device=CPU)]
    assert got == want
    assert [len(c) for _, c in got] == list(range(1, 900))


def _minhash_corpus():
    rng = np.random.default_rng(17)
    hashes = []
    for c in range(4):
        base = np.unique(rng.integers(0, 1 << 48, size=500,
                                      dtype=np.uint64))
        for g in range(4):
            keep = base[rng.random(len(base)) > 0.05 * g]
            hashes.append(np.unique(keep))
        # exact duplicates: every later copy ties (max common / min dist)
        # against several reps -> exercises first-touch resolution
        hashes.append(base.copy())
        hashes.append(base.copy())
    return hashes


@pytest.mark.parametrize("path", ["fast", "slow"])
@pytest.mark.parametrize("cont", [False, True], ids=["mash", "aaf"])
def test_minhash_greedy_device_matches_parity(path, cont):
    """The device-swept MinHash greedy == the JAX reference-parity host
    engine: fast path (identical param sizes, winner = max common), slow
    path (mixed param sizes: the rep-side param-size asymmetry),
    containment, exact-duplicate ties (first-touch order)."""
    hashes = _minhash_corpus()
    psz = ([500] * len(hashes) if path == "fast"
           else [400 + 37 * (i % 5) for i in range(len(hashes))])
    host = jax_greedy.minhash_greedy_parity(hashes, psz, 0.05, 21, cont)
    _same(host, port_gd.minhash_greedy_device(hashes, psz, 0.05, 21, cont,
                                              device=CPU))
    _same(host, port_greedy.minhash_greedy_parity(hashes, psz, 0.05, 21,
                                                  cont))


def test_minhash_greedy_device_fast_path_heterogeneous_sizes():
    """Fast path with param sizes that change after the sampled first
    min(100, n) genomes: the reference applies the FIXED bound from
    psizes[0] to every pair, so the filter must never prune with the
    tighter per-pair bound of a later, larger param size."""
    rng2 = np.random.default_rng(31)
    big = []
    for c in range(13):
        base = np.unique(rng2.integers(0, 1 << 48, size=280,
                                       dtype=np.uint64))
        for g in range(9):
            big.append(np.unique(base[rng2.random(len(base)) > 0.35]))
    psz3 = [300] * 100 + [900] * (len(big) - 100)
    host = jax_greedy.minhash_greedy_parity(big, psz3, 0.05, 21, False)
    _same(host, jax_gd.minhash_greedy_device(big, psz3, 0.05, 21, False))
    _same(host, port_gd.minhash_greedy_device(big, psz3, 0.05, 21, False,
                                              device=CPU))


def test_minhash_greedy_threshold_one_takes_the_host_engine():
    hashes = _minhash_corpus()
    psz = [500] * len(hashes)
    host = jax_greedy.minhash_greedy_parity(hashes, psz, 1.0, 21, False)
    _same(host, port_gd.minhash_greedy_device(hashes, psz, 1.0, 21, False,
                                              device=CPU))


def test_greedy_density_probe_classifies_corpora():
    """The --device greedy crossover probe separates a big-cluster corpus
    (dense -> native) from a mostly-singleton one (sparse -> device), as
    the JAX probe does; below 16,384 genomes everything counts as dense."""
    def corpus(n, n_clusters, s=200, seed=3):
        rng = np.random.default_rng(seed)
        bases = [np.unique(rng.integers(0, 2 ** 31, size=s).astype(
            np.uint32)) for _ in range(n_clusters)]
        out = []
        for i in range(n):
            b = bases[i % n_clusters]
            keep = b[rng.random(len(b)) < 0.8]
            extra = np.unique(rng.integers(
                0, 2 ** 31, size=s - len(keep)).astype(np.uint32))
            out.append(np.unique(np.concatenate([keep, extra])))
        return out

    n = 16384
    dense = corpus(n, n // 200)
    sparse = corpus(n, n // 2)
    st = {}
    assert port_dense(dense, 0.05, 21, stats=st) and jax_dense(dense, 0.05,
                                                               21)
    assert st["probe_degree"] >= 10.0
    assert not port_dense(sparse, 0.05, 21, stats=st)
    assert not jax_dense(sparse, 0.05, 21)
    assert st["probe_degree"] < 10.0
    small = corpus(512, 256)
    assert port_dense(small, 0.05, 21) and jax_dense(small, 0.05, 21)


def _native_corpus(use64=False):
    """Overlapping clusters with noise (tests/test_greedy.py's native-vs-
    Python corpus)."""
    rng = np.random.default_rng(11)
    bases = [np.unique(rng.integers(0, 2 ** 31, size=300).astype(np.uint32))
             for _ in range(6)]
    hashes = []
    for i in range(60):
        b = bases[i % 6]
        keep = b[rng.random(len(b)) < 0.85]
        extra = np.unique(rng.integers(0, 2 ** 31, size=60).astype(np.uint32))
        hashes.append(np.unique(np.concatenate([keep, extra])))
    if use64:
        hashes = [h.astype(np.uint64) for h in hashes]
    return hashes


@pytest.mark.parametrize("use64", [False, True], ids=["u32", "u64"])
@pytest.mark.parametrize("cont", [False, True], ids=["mash", "aaf"])
@pytest.mark.parametrize("pi", [0, 16], ids=["default_prune", "prune_16"])
def test_native_greedy_cluster_matches_jax(use64, cont, pi):
    hashes = _native_corpus(use64)
    got = port_greedy.greedy_cluster(hashes, 0.05, 21, is_containment=cont,
                                     prune_interval=pi)
    for backend in ("native", "python"):
        _same(jax_greedy.greedy_cluster(hashes, 0.05, 21,
                                        is_containment=cont,
                                        backend=backend, prune_interval=pi),
              got, backend)
    order = port_base.stdsort_size_desc(np.array([len(h) for h in hashes]))
    inv = [hashes[i] for i in order]
    _same(jax_greedy.greedy_cluster(inv, 0.05, 21, presorted=True,
                                    is_containment=cont, prune_interval=pi),
          port_greedy.greedy_cluster(inv, 0.05, 21, presorted=True,
                                     is_containment=cont, prune_interval=pi))


@pytest.mark.parametrize("cont", [False, True], ids=["mash", "aaf"])
def test_native_minhash_parity_matches_jax(cont):
    hashes = _minhash_corpus()
    psz = [400 + 37 * (i % 5) for i in range(len(hashes))]
    got = port_greedy.minhash_greedy_parity(hashes, psz, 0.05, 21, cont)
    for backend in ("native", "python"):
        _same(jax_greedy.minhash_greedy_parity(hashes, psz, 0.05, 21, cont,
                                               backend=backend), got, backend)


def test_greedy_orders_match_jax():
    """The KSSD greedy order (libstdc++ std::sort: unstable on size ties,
    so id order is lost above 16 genomes) and the presketched MinHash
    order equal the JAX package's; reorder and extend keep param sizes."""
    rng = np.random.default_rng(2)
    sizes = rng.integers(5, 9, size=200)  # many ties
    want = jax_base.stdsort_size_desc(sizes)
    got = port_base.stdsort_size_desc(sizes)
    assert np.array_equal(want, got)
    assert not np.array_equal(got, np.lexsort((np.arange(200), -sizes)))

    def fill(mod):
        ss = mod.SketchSet("minhash", None, True, True)
        for i, sz in enumerate(sizes.tolist()):
            ss.append_genome(file_name=f"f{i}", name=f"g{i}", comment="c",
                             seq0_len=100 + i % 7, total_len=1000 + i % 5,
                             num_seqs=1, hashes=np.arange(sz, dtype=np.uint64),
                             param_size=300 + i)
        return ss

    jss, pss = fill(jax_base), fill(port_base)
    assert np.array_equal(jss.kssd_greedy_order(), pss.kssd_greedy_order())
    order = jss.minhash_presketched_order()
    assert np.array_equal(order, pss.minhash_presketched_order())
    jr, pr = jss.reorder(order), pss.reorder(order)
    assert pr.param_sizes == jr.param_sizes and pr.names == jr.names
    pr.extend(pss)
    assert pr.param_sizes == jr.param_sizes + pss.param_sizes
    with pytest.raises(ValueError):
        pr.extend(port_base.SketchSet("kssd", None, True, True))


def _batched_corpus():
    """8 clusters of overlapping sketches of varied size and 10 singletons
    (tests/test_device_engine.py: test_greedy_device_matches_host_batched)."""
    rng = np.random.default_rng(5)
    hashes = []
    for c in range(8):
        base = rng.choice(1 << 22, size=600, replace=False).astype(np.uint32)
        for g in range(6):
            keep = rng.random(len(base)) > 0.05 * g
            extra = rng.choice(1 << 22, size=30 * g, replace=False)
            hashes.append(np.unique(np.r_[base[keep],
                                          extra.astype(np.uint32)]))
    for _ in range(10):
        hashes.append(np.unique(
            rng.choice(1 << 22, size=400).astype(np.uint32)))
    return hashes


@pytest.mark.parametrize("cont", [False, True], ids=["mash", "aaf"])
@pytest.mark.parametrize("bs", [7, 64])
def test_batched_conflict_matches_jax(bs, cont):
    """conflict="batched" (K6's route) equals the JAX device route and the
    copied host engine, greedy_cluster_batched, at both batch sizes."""
    hashes = _batched_corpus()
    want = jax_greedy.greedy_cluster_batched(hashes, 0.05, 21, batch_size=bs,
                                             is_containment=cont)
    _same(want, jax_gd.greedy_cluster_device(
        hashes, 0.05, 21, batch_size=bs, is_containment=cont,
        conflict="batched"))
    _same(want, port_greedy.greedy_cluster_batched(
        hashes, 0.05, 21, batch_size=bs, is_containment=cont))
    stats = {}
    _same(want, port_gd.greedy_cluster_device(
        hashes, 0.05, 21, batch_size=bs, is_containment=cont,
        conflict="batched", device=CPU, stats=stats))
    assert stats["sweep_s"] >= 0 and stats["replay_s"] >= 0


@pytest.mark.parametrize("triangular", [False, True], ids=["rect", "tri"])
@pytest.mark.parametrize("cont", [False, True], ids=["mash", "aaf"])
@pytest.mark.parametrize("b,r,cap", [(7, 1024, 4096), (64, 40, 300),
                                     (64, 40, 5)],
                         ids=["b7", "b64", "past_cap"])
def test_greedy_filter_plain_equals_jax(b, r, cap, cont, triangular):
    """Plain K6 returns JAX's whole fused buffer [count, flat_idx (cap)],
    the -1 tail and a count past cap included; pad slots point at the
    zero-size padding row."""
    import jax.numpy as jnp
    hashes = _batched_corpus()
    xp, coll = port_bm.pack_bitmaps_packed(hashes, bits=512, pad_n_to=128)
    n_pad = xp.shape[0]
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:len(hashes)] = [len(h) for h in hashes]
    rng = np.random.default_rng(b * r)
    bi = rng.integers(0, n_pad, b).astype(np.int32)
    ri = bi.copy() if triangular else \
        rng.integers(0, n_pad, r).astype(np.int32)
    ri[-1] = n_pad - 1
    sc = port_bm.filter_scalars(0.05, 21, "greedy")
    want = np.asarray(jax_gd._greedy_filter_fn(
        jnp.asarray(xp), jnp.asarray(bi), jnp.asarray(ri), jnp.asarray(coll),
        jnp.asarray(sizes), *(jnp.float32(v) for v in sc), cont, cap,
        triangular))
    got = port_gd.greedy_filter_plain(
        torch.from_numpy(xp), torch.from_numpy(bi), torch.from_numpy(ri),
        torch.from_numpy(coll), torch.from_numpy(sizes), *sc, cont, cap,
        triangular)
    assert np.array_equal(got.numpy(), want)
    # the wrapper on CPU tensors takes the plain version
    assert torch.equal(port_gd.greedy_filter(
        torch.from_numpy(xp), bi, ri, torch.from_numpy(coll),
        torch.from_numpy(sizes), *sc, cont, cap, triangular), got)


def test_greedy_filter_rejects_indices_outside():
    xp = torch.zeros((128, 64), dtype=torch.uint8)
    z = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="rep_idx"):
        port_gd.greedy_filter(xp, [0, 1], [0, 128], z, z,
                              *port_bm.filter_scalars(0.05, 21, "greedy"),
                              False, 16)
    with pytest.raises(ValueError, match="conflict"):
        port_gd.greedy_cluster_device(_serial_corpus(), 0.05, 21,
                                      conflict="other", device=CPU)


def test_batchloop_mode_runs_the_sweep(monkeypatch, capsys):
    """RTC_GREEDY_DEVICE=batchloop (the JAX package's legacy per-batch
    loop, which the JAX tests hold equal to the sweep) prints a note and
    runs the sweep."""
    hashes = _serial_corpus()
    monkeypatch.setenv("RTC_GREEDY_DEVICE", "batchloop")
    got = port_gd.greedy_cluster_device(hashes, 0.05, 21, device=CPU)
    assert "batchloop" in capsys.readouterr().err
    _same(jax_gd.greedy_cluster_device(hashes, 0.05, 21), got)

"""The port's state files (``state/greedy_state.py``, ``state/mst_state.py``)
on the CPU against the JAX package's, on the same seeded inputs: the same
state built in both packages, its ``cluster_state.bin`` (KSSI02),
``REPDB002``, MinHash and ``mst_cluster_state.bin`` files byte-equal, each
package loading the other's file, and ``incremental_cluster``,
``append_cluster``, ``query_topk``, ``assign``, ``print_stats`` and the
``.cluster`` writers equal; ``batch_query_device`` (K1's plain version on
the CPU) equal to JAX's and to the serial ``query_topk`` loop.  Also the
state tests of ``tests/test_persistence.py`` and
``tests/test_minhash_states.py`` on the port's own sketches of the
synthetic genomes."""

import io

import numpy as np
import pytest
import torch

from rabbittclust_tpu.cluster import greedy as jax_greedy
from rabbittclust_tpu.cluster import mst as jax_mst
from rabbittclust_tpu.sketch import base as jax_base
from rabbittclust_tpu.sketch import kssd as jax_kssd
from rabbittclust_tpu.sketch import minhash as jax_minhash
from rabbittclust_tpu.state import greedy_state as jax_gs
from rabbittclust_tpu.state import mst_state as jax_ms
from rabbittclust_tpu_torch.cluster import greedy as port_greedy
from rabbittclust_tpu_torch.cluster import mst as port_mst
from rabbittclust_tpu_torch.sketch import base as port_base
from rabbittclust_tpu_torch.sketch import kssd as port_kssd
from rabbittclust_tpu_torch.sketch import minhash as port_minhash
from rabbittclust_tpu_torch.state import greedy_state as port_gs
from rabbittclust_tpu_torch.state import mst_state as port_ms
from rabbittclust_tpu_torch.state.postings import (pack_postings,
                                                   read_postings)
from tests.helpers import clusters_to_labels, same_partition

CPU = torch.device("cpu")
THRESHOLD = 0.05

SIDES = {
    "jax": dict(base=jax_base, kssd=jax_kssd, minhash=jax_minhash,
                greedy=jax_greedy, mst=jax_mst, gs=jax_gs, ms=jax_ms),
    "port": dict(base=port_base, kssd=port_kssd, minhash=port_minhash,
                 greedy=port_greedy, mst=port_mst, gs=port_gs, ms=port_ms),
}


def _corpus(n=96, s=160, n_clusters=12, seed=21, dtype=np.uint32,
            shared=4000, novel=3):
    """Planted clusters (keep 0.75 of a base) with noise drawn from a small
    pool, so hashes recur across representatives (posting lists longer
    than one); hashes of 64-bit sets reach 2^64.  The last ``2 * novel``
    genomes are pairs of ``novel`` clusters of their own (new
    representatives when appended)."""
    rng = np.random.default_rng(seed)
    hi = 2 ** 31 if dtype == np.uint32 else 2 ** 64
    pool = np.unique(rng.integers(0, hi, size=shared, dtype=np.uint64)
                     ).astype(dtype)
    bases = [np.unique(rng.integers(0, hi, size=s, dtype=np.uint64)
                       ).astype(dtype) for _ in range(n_clusters)]
    bases += [np.unique(rng.integers(0, hi, size=s, dtype=np.uint64)
                        ).astype(dtype) for _ in range(novel)]
    out = []
    for i in range(n + 2 * novel):
        b = bases[i % n_clusters if i < n else n_clusters + (i - n) // 2]
        kept = b[rng.random(len(b)) < 0.75]
        noise = rng.choice(pool, size=int(rng.integers(10, 60)),
                           replace=False)
        out.append(np.unique(np.concatenate([kept, noise])))
    return out


def _sketchset(side, hashes, kind, params, names=None):
    ss = SIDES[side]["base"].SketchSet(kind, params, True,
                                       hashes[0].dtype == np.uint64)
    for i, h in enumerate(hashes):
        name = names[i] if names else f"genome_{i}"
        ss.append_genome(file_name=f"{name}.fna", name=name,
                         comment=f"c{i % 7}", seq0_len=1000 + i,
                         total_len=5000 + 37 * i, num_seqs=1, hashes=h,
                         param_size=len(h))
    return ss


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _stats(st):
    buf = io.StringIO()
    st.print_stats(buf)
    return buf.getvalue()


def _queries(hashes, reps=(), seed=5, n_novel=6):
    """Members of the corpus, their 0.8 subsets, mixtures of two of
    ``reps`` (several hits each), and novel sets."""
    rng = np.random.default_rng(seed)
    dt = hashes[0].dtype
    out = [h for h in hashes[::7]]
    out += [h[rng.random(len(h)) < 0.8] for h in hashes[3::11]]
    out += [np.union1d(a[rng.random(len(a)) < 0.7],
                       b[rng.random(len(b)) < 0.7])
            for a, b in zip(reps[0::2], reps[1::2])]
    hi = 2 ** 31 if dt == np.uint32 else 2 ** 64
    out += [np.unique(rng.integers(0, hi, size=150, dtype=np.uint64)
                      ).astype(dt) for _ in range(n_novel)]
    out.append(np.empty(0, dtype=dt))
    return out


def _kssd_states(dtype, tmp_path, k=72):
    """The greedy KSSD state of the first ``k`` genomes in both packages
    (sorted as the CLIs sort), and the genomes left to append."""
    hashes = _corpus(dtype=dtype)
    p_kmer = 21 if dtype == np.uint32 else 23
    out = {}
    for side, m in SIDES.items():
        p = m["kssd"].KssdParams.from_kmer_size(p_kmer, 3 if dtype ==
                                                np.uint32 else 2)
        ss = _sketchset(side, hashes[:k], "kssd", p)
        ss2 = ss.reorder(ss.kssd_greedy_order())
        gres = m["greedy"].greedy_cluster(ss2.hashes, THRESHOLD, p.kmer_size,
                                          presorted=True)
        st = m["gs"].KssdClusterState.from_clustering(ss2, p, gres,
                                                      THRESHOLD)
        extra = _sketchset(side, hashes[k:], "kssd", p,
                           names=[f"new_{i}" for i in range(len(hashes) - k)])
        out[side] = (st, extra)
    assert out["jax"][0].clusters == out["port"][0].clusters
    assert out["jax"][0].inverted_index == out["port"][0].inverted_index
    return hashes, out


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64],
                         ids=["32-bit", "64-bit"])
def test_kssd_cluster_state_equals_jax(dtype, tmp_path):
    hashes, states = _kssd_states(dtype, tmp_path)
    assert any(len(v) > 1 for v in states["port"][0].inverted_index.values())
    files = {}
    for side, (st, _) in states.items():
        d = tmp_path / side
        d.mkdir()
        st.save(str(d / "cluster_state.bin"))
        st.save_repdb(str(d / "rep.db"))
        files[side] = d
    for name in ("cluster_state.bin", "rep.db"):
        assert _bytes(files["jax"] / name) == _bytes(files["port"] / name)
    # each package loads the other's files
    for load_side, file_side in (("jax", "port"), ("port", "jax")):
        cls = SIDES[load_side]["gs"].KssdClusterState
        full = cls.load(str(files[file_side] / "cluster_state.bin"))
        rep = cls.load_repdb(str(files[file_side] / "rep.db"))
        st = states[load_side][0]
        for got in (full, rep):
            assert got.representative_ids == st.representative_ids
            assert got.clusters == st.clusters
            assert got.inverted_index == st.inverted_index
            assert got.file_names == st.file_names
            assert got.total_lens == st.total_lens
            assert got.use64 == (dtype == np.uint64)
        assert all(np.array_equal(a, b) for a, b in zip(full.hashes,
                                                        st.hashes))
    # query / assign / stats on both loaded RepDBs
    reps = {side: SIDES[side]["gs"].KssdClusterState.load_repdb(
        str(files[side] / "rep.db")) for side in SIDES}
    st = states["port"][0]
    qs = _queries(hashes, [st.hashes[g] for g in st.representative_ids])
    for q in qs:
        assert reps["jax"].query_topk(q, 3) == reps["port"].query_topk(q, 3)
        assert reps["jax"].assign(q) == reps["port"].assign(q)
    assert _stats(reps["jax"]) == _stats(reps["port"])
    assert _stats(states["jax"][0]) == _stats(states["port"][0])
    # the incremental pass over the loaded full state, then its files and
    # its .cluster (loaded states print N/A for their old members)
    for side in SIDES:
        cls = SIDES[side]["gs"].KssdClusterState
        st = cls.load(str(files[side] / "cluster_state.bin"))
        st.incremental_cluster(states[side][1])
        st.save(str(files[side] / "after.bin"))
        st.save_repdb(str(files[side] / "after.db"))
        st.write_cluster_result(str(files[side] / "out.cluster"))
        states[side] = st
    assert states["jax"].clusters == states["port"].clusters
    assert states["jax"].representative_ids == \
        states["port"].representative_ids
    # a cluster made by the incremental pass leaves its representative out
    st = states["port"]
    assert any(r not in cl for r, cl in zip(st.representative_ids,
                                            st.clusters))
    for name in ("after.bin", "after.db", "out.cluster"):
        assert _bytes(files["jax"] / name) == _bytes(files["port"] / name)
    assert _stats(states["jax"]) == _stats(states["port"])


@pytest.mark.parametrize("containment", [False, True],
                         ids=["mash", "containment"])
def test_minhash_cluster_state_equals_jax(containment, tmp_path):
    hashes = _corpus(dtype=np.uint64, seed=4)
    k = 72
    out, files = {}, {}
    for side, m in SIDES.items():
        p = m["minhash"].MinHashParams(
            kmer_size=21, sketch_size=0 if containment else 200,
            is_containment=containment,
            contain_compress=100 if containment else 0)
        ss = _sketchset(side, hashes[:k], "minhash", p)
        ss2 = ss.reorder(ss.sort_by_size_desc())
        gres = m["greedy"].greedy_cluster(ss2.hashes, THRESHOLD, 21,
                                          presorted=True,
                                          is_containment=containment)
        st = m["gs"].MinHashClusterState.from_clustering(ss2, p, gres,
                                                         THRESHOLD)
        d = tmp_path / side
        d.mkdir()
        st.save(str(d / "cluster_state.bin"))
        st.save_repdb(str(d / "mh.db"))
        st.write_cluster_result(str(d / "fresh.cluster"), THRESHOLD)
        out[side] = (st, _sketchset(side, hashes[k:], "minhash", p,
                                    names=[f"new_{i}"
                                           for i in range(len(hashes) - k)]))
        files[side] = d
    assert out["jax"][0].clusters == out["port"][0].clusters
    for name in ("cluster_state.bin", "mh.db", "fresh.cluster"):
        assert _bytes(files["jax"] / name) == _bytes(files["port"] / name)
    st = out["port"][0]
    qs = _queries(hashes, [st.hashes[g] for g in st.representative_ids])
    for load_side, file_side in (("jax", "port"), ("port", "jax")):
        cls = SIDES[load_side]["gs"].MinHashClusterState
        for name in ("cluster_state.bin", "mh.db"):
            got = cls.load(str(files[file_side] / name))
            st = out[load_side][0]
            assert got.is_containment == containment
            assert got.representative_ids == st.representative_ids
            assert got.clusters == st.clusters
            assert got.inverted_index == st.inverted_index
            for q in qs:
                assert got.query_topk(q, 4) == st.query_topk(q, 4)
                assert got.assign(q) == st.assign(q)
    for side in SIDES:
        st = SIDES[side]["gs"].MinHashClusterState.load(
            str(files[side] / "cluster_state.bin"))
        st.incremental_cluster(out[side][1])
        st.save(str(files[side] / "after.bin"))
        st.write_cluster_result(str(files[side] / "out.cluster"))
        out[side] = st
    assert out["jax"].clusters == out["port"].clusters
    for name in ("after.bin", "out.cluster"):
        assert _bytes(files["jax"] / name) == _bytes(files["port"] / name)
    assert _stats(out["jax"]) == _stats(out["port"])


MST_KINDS = {"kssd32": ("kssd", np.uint32), "kssd64": ("kssd", np.uint64),
             "minhash": ("minhash", np.uint64)}


@pytest.mark.parametrize("kind", list(MST_KINDS))
def test_mst_state_equals_jax(kind, tmp_path):
    flavor, dtype = MST_KINDS[kind]
    hashes = _corpus(dtype=dtype, seed=8)
    k = 72
    out, files = {}, {}
    for side, m in SIDES.items():
        base = _sketchset(side, hashes[:k], flavor, None)
        res = m["mst"].compute_mst(base.hashes, THRESHOLD, 21)
        forest = m["mst"].cut_forest(res.mst, THRESHOLD)
        clusters = m["mst"].clusters_from_forest(forest, k)
        if flavor == "kssd":
            p = m["kssd"].KssdParams.from_kmer_size(21, 3)
            st = m["ms"].KssdMstState.from_clustering(base, p, res.mst,
                                                      clusters, THRESHOLD)
        else:
            st = m["ms"].MstState.from_clustering(
                base, "minhash", forest, clusters, THRESHOLD, kmer_size=21,
                sketch_size=200, contain_compress=0, is_containment=False)
        d = tmp_path / side
        d.mkdir()
        st.save(str(d / "mst_cluster_state.bin"))
        out[side] = st
        files[side] = d
    assert out["jax"].representative_ids == out["port"].representative_ids
    assert _bytes(files["jax"] / "mst_cluster_state.bin") == \
        _bytes(files["port"] / "mst_cluster_state.bin")
    qs = _queries(hashes, out["port"].rep_hashes)
    for load_side, file_side in (("jax", "port"), ("port", "jax")):
        got = SIDES[load_side]["ms"].MstState.load(
            str(files[file_side] / "mst_cluster_state.bin"))
        st = out[load_side]
        assert got.kind == flavor and got.clusters == st.clusters
        assert got.inverted_index == st.inverted_index
        assert got.member_names == st.member_names
        for q in qs:
            assert got.query_topk(q, 3) == st.query_topk(q, 3)
            assert got.query_topk(q, 0) == st.query_topk(q, 0)
            assert got.assign(q) == st.assign(q)
    assert _stats(out["jax"]) == _stats(out["port"])
    lives = {}
    for side in SIDES:
        st = SIDES[side]["ms"].MstState.load(
            str(files[side] / "mst_cluster_state.bin"))
        extra = _sketchset(side, hashes[k:], flavor, None,
                           names=[f"new_{i}" for i in range(len(hashes) - k)])
        lives[side] = st.append_cluster(extra)
        st.save(str(files[side] / "after.bin"))
        st.write_cluster_result(lives[side], str(files[side] / "out.cluster"),
                                st.threshold)
        out[side] = st
    assert lives["jax"] == lives["port"]
    for name in ("after.bin", "out.cluster"):
        assert _bytes(files["jax"] / name) == _bytes(files["port"] / name)
    assert _stats(out["jax"]) == _stats(out["port"])


@pytest.mark.parametrize("pull", ["mask", "idx"])
def test_batch_query_device_equals_jax_and_serial(pull, tmp_path,
                                                  monkeypatch):
    """K1's plain version on the CPU (and K3's under idx): the probe's hits
    equal JAX's ``batch_query_device`` and the serial loop, field for
    field, distances exactly."""
    monkeypatch.setenv("RTC_PULL_MODE", pull)
    hashes, states = _kssd_states(np.uint32, tmp_path)
    st = states["port"][0]
    qs = _queries(hashes, [st.hashes[g] for g in st.representative_ids])
    want = jax_gs.batch_query_device(states["jax"][0], qs, topk=3)
    got = port_gs.batch_query_device(states["port"][0], qs, 3, device=CPU)
    serial = [states["port"][0].query_topk(q, 3) for q in qs]
    assert got == want == serial
    assert any(len(r) > 1 for r in got) and any(not r for r in got)


def test_batch_query_device_needs_cuda(monkeypatch):
    """``device=None`` is cuda:0, as for every entry point of the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = port_gs.KssdClusterState(
        params=port_kssd.KssdParams.from_kmer_size(21, 3), threshold=0.05,
        kmer_size=22)
    st.hashes = [np.arange(10, dtype=np.uint32)]
    st.representative_ids, st.clusters = [0], [[0]]
    st.build_inverted_index()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_gs.batch_query_device(st, [np.arange(5, dtype=np.uint32)], 1)


@pytest.mark.parametrize("key_bytes", [4, 8])
def test_postings_equal_the_hash_by_hash_index(key_bytes):
    """The port's index against the JAX package's index code: the dict
    its ``_index_add`` loop builds, and ``postings.py``'s bytes against
    those its ``_write_index`` writes, read back by its ``_read_index``."""
    hashes = _corpus(dtype=np.uint32, seed=2, shared=300)
    hashes.append(np.empty(0, dtype=np.uint32))
    st = jax_gs.KssdClusterState(params=None, threshold=0.05, kmer_size=22)
    for r, h in enumerate(hashes):
        st._index_add(r, h)
    pst = port_gs.KssdClusterState(params=None, threshold=0.05,
                                   kmer_size=22)
    for r, h in enumerate(hashes):
        pst._index_add(r, h)
    index = pst.inverted_index
    assert index == st.inverted_index
    assert list(map(list, index.values())) == \
        [st.inverted_index[k] for k in index]
    buf = io.BytesIO()
    st._write_index(buf)
    if key_bytes == 8:
        assert pack_postings(index, 8) == buf.getvalue()
    blob = b"pad" + pack_postings(index, key_bytes)
    want, end = jax_gs.KssdClusterState._read_index(blob, 3, key_bytes == 8)
    assert end == len(blob)
    assert read_postings(blob, 3, key_bytes) == (want, end)
    assert read_postings(pack_postings({}, 8), 0, 8) == ({}, 8)


# tests/test_persistence.py and tests/test_minhash_states.py on the port's
# sketches of the synthetic genomes, each against the JAX package

def _kssd_sketches(side, genomes):
    return SIDES[side]["kssd"].sketch_files_kssd(genomes.files, 1000, 19, 2)


def _mh_sketches(side, genomes, **kw):
    m = SIDES[side]["minhash"]
    p = m.MinHashParams(kmer_size=21, **kw)
    return m.sketch_files_minhash(genomes.files, 1000, p), p


def _greedy_state(side, ss, p, containment=False):
    m = SIDES[side]
    ss2 = ss.reorder(ss.sort_by_size_desc())
    gres = m["greedy"].greedy_cluster(ss2.hashes, THRESHOLD, p.kmer_size,
                                      presorted=True,
                                      is_containment=containment)
    cls = (m["gs"].KssdClusterState if ss.kind == "kssd"
           else m["gs"].MinHashClusterState)
    return cls.from_clustering(ss2, p, gres, THRESHOLD)


def test_greedy_state_roundtrip(tmp_path, synthetic_genomes):
    paths = {}
    for side in SIDES:
        st = _greedy_state(side, *_kssd_sketches(side, synthetic_genomes))
        paths[side] = str(tmp_path / f"{side}.bin")
        st.save(paths[side])
        st2 = SIDES[side]["gs"].KssdClusterState.load(paths[side])
        assert st2.threshold == st.threshold
        assert st2.representative_ids == st.representative_ids
        assert st2.clusters == st.clusters
        assert st2.inverted_index == st.inverted_index
        assert all(np.array_equal(a, b) for a, b in zip(st.hashes,
                                                        st2.hashes))
    assert _bytes(paths["jax"]) == _bytes(paths["port"])


def test_repdb_roundtrip_and_query(tmp_path, synthetic_genomes):
    paths = {}
    for side in SIDES:
        st = _greedy_state(side, *_kssd_sketches(side, synthetic_genomes))
        paths[side] = str(tmp_path / f"{side}.db")
        st.save_repdb(paths[side])
        assert _bytes(paths[side])[:8] == b"REPDB002"
        st2 = SIDES[side]["gs"].KssdClusterState.load_repdb(paths[side])
        for rep_idx, gid in enumerate(st.representative_ids):
            res = st2.query_topk(st.hashes[gid], 1)
            assert res and res[0]["distance"] == 0.0
            assert res[0]["rep_idx"] == rep_idx
        for cid, cl in enumerate(st.clusters):
            for gid in cl:
                assert st2.assign(st.hashes[gid])["cluster_id"] == cid
    assert _bytes(paths["jax"]) == _bytes(paths["port"])


def _with_reps(clusters, reps):
    """The partition with each cluster's representative put back (the
    incremental pass leaves a new rep out of its own member list)."""
    return [([rep] if rep not in cl else []) + list(cl)
            for cl, rep in zip(clusters, reps)]


@pytest.mark.parametrize("flavor", ["kssd", "minhash"])
def test_incremental_matches_full(flavor, synthetic_genomes):
    """The incremental pass over the last 5 genomes gives the planted
    partition (the representative put back), the same clusters as JAX's."""
    got = {}
    for side in SIDES:
        if flavor == "kssd":
            ss, p = _kssd_sketches(side, synthetic_genomes)
        else:
            ss, p = _mh_sketches(side, synthetic_genomes, sketch_size=300)
        k = len(ss) - 5
        base = ss.reorder(np.arange(k))
        extra = ss.reorder(np.arange(k, len(ss)))
        order = base.sort_by_size_desc()
        st = _greedy_state(side, base, p)
        st.incremental_cluster(extra)
        idmap = [int(order[i]) for i in range(k)] + list(range(k, len(ss)))
        got[side] = [[idmap[g] for g in cl] for cl in
                     _with_reps(st.clusters, st.representative_ids)]
    assert got["jax"] == got["port"]
    labels = clusters_to_labels(got["port"], len(synthetic_genomes.files))
    assert same_partition(labels, synthetic_genomes.labels)


def test_mst_state_roundtrip_and_append(tmp_path, synthetic_genomes):
    lives = {}
    for side, m in SIDES.items():
        ss, p = _kssd_sketches(side, synthetic_genomes)
        k = len(ss) - 5
        base = ss.reorder(np.arange(k))
        extra = ss.reorder(np.arange(k, len(ss)))
        res = m["mst"].compute_mst(base.hashes, THRESHOLD, p.kmer_size)
        clusters = m["mst"].clusters_from_forest(
            m["mst"].cut_forest(res.mst, THRESHOLD), k)
        st = m["ms"].KssdMstState.from_clustering(base, p, res.mst,
                                                  clusters, THRESHOLD)
        path = str(tmp_path / f"{side}.bin")
        st.save(path)
        st2 = m["ms"].MstState.load(path)
        assert st2.representative_ids == st.representative_ids
        assert st2.clusters == st.clusters
        lives[side] = st2.append_cluster(extra)
    assert _bytes(tmp_path / "jax.bin") == _bytes(tmp_path / "port.bin")
    assert lives["jax"] == lives["port"]
    labels = clusters_to_labels(lives["port"], len(synthetic_genomes.files))
    assert same_partition(labels, synthetic_genomes.labels)


@pytest.mark.parametrize("containment", [False, True],
                         ids=["mash", "containment"])
def test_minhash_greedy_recovery(containment, synthetic_genomes):
    kw = (dict(sketch_size=0, is_containment=True, contain_compress=100)
          if containment else dict(sketch_size=300))
    got = {}
    for side in SIDES:
        ss, p = _mh_sketches(side, synthetic_genomes, **kw)
        got[side] = SIDES[side]["greedy"].greedy_cluster(
            ss.hashes, THRESHOLD, p.kmer_size,
            is_containment=containment).clusters
    assert got["jax"] == got["port"]
    labels = clusters_to_labels(got["port"], len(synthetic_genomes.files))
    assert same_partition(labels, synthetic_genomes.labels)


def test_minhash_state_roundtrip_and_query(tmp_path, synthetic_genomes):
    for side in SIDES:
        ss, p = _mh_sketches(side, synthetic_genomes, sketch_size=300)
        st = _greedy_state(side, ss, p)
        st.save_repdb(str(tmp_path / f"{side}.db"))
        st2 = SIDES[side]["gs"].MinHashClusterState.load_repdb(
            str(tmp_path / f"{side}.db"))
        assert st2.kmer_size == 21 and st2.sketch_size == 300
        assert st2.representative_ids == st.representative_ids
        assert st2.clusters == st.clusters
        for rep_idx, gid in enumerate(st.representative_ids):
            res = st2.query_topk(st.hashes[gid], 1)
            assert res and res[0]["distance"] == 0.0
            assert res[0]["rep_idx"] == rep_idx
    assert _bytes(tmp_path / "jax.db") == _bytes(tmp_path / "port.db")


def test_batch_query_device_matches_serial(synthetic_genomes):
    got = {}
    for side in SIDES:
        ss, p = _kssd_sketches(side, synthetic_genomes)
        st = _greedy_state(side, ss, p)
        queries = st.hashes[:10]
        kw = {"device": CPU} if side == "port" else {}
        batched = SIDES[side]["gs"].batch_query_device(st, queries, 3, **kw)
        for q, res in enumerate(batched):
            serial = st.query_topk(queries[q], 3)
            assert [(r["rep_idx"], round(r["distance"], 12)) for r in res] \
                == [(r["rep_idx"], round(r["distance"], 12))
                    for r in serial]
        got[side] = batched
    assert got["jax"] == got["port"]

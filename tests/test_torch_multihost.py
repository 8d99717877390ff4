"""The port's stats ring and multi-process mesh on the CPU against the JAX
package.

* ``distributed_candidate_stats`` over ``[cpu] * k`` against JAX's on
  ``make_mesh(k)`` (conftest's 8 virtual CPU devices), k in 1, 2, 3, 4
  and 8, on the dry run's corpus and on ``test_device_engine.py``'s
  sketches: the count equal, the float32 minimum within 4 ulp (XLA's,
  torch's and CUDA's ``log`` may differ in the last place); every corpus
  keeps its pairs' float64 distances more than 1e-5 from the threshold,
  so the equal count is well defined.
* ``shard_bounds`` and the byte-exact ragged allgather (one gloo rank).
* ``launch_local_sim``: every child asserts its results against the port's
  single-process engines and writes them to a file; here they are held to
  the JAX package's single-host engines on the same inputs (the RepDB
  probe and assignment to the JAX state's serial ``query_topk`` and
  ``assign`` loops).
* ``dryrun_multichip`` over CPU shards.
"""

import pickle
import signal
import sys
import time

import numpy as np
import pytest
import torch

from rabbittclust_tpu.cluster import dbscan as jdb
from rabbittclust_tpu.cluster.greedy import greedy_cluster as jax_greedy
from rabbittclust_tpu.cluster.leiden import (build_similarity_graph,
                                             community_clusters)
from rabbittclust_tpu.cluster.mst import (clusters_from_forest, compute_mst,
                                          cut_forest)
from rabbittclust_tpu.ops.pack import pack_sketches as jax_pack
from rabbittclust_tpu.parallel import dist_engine as jde
from rabbittclust_tpu.parallel import multihost as jmh
from rabbittclust_tpu.sketch.base import stdsort_size_desc
from rabbittclust_tpu.sketch.kssd import sketch_files_kssd
from rabbittclust_tpu_torch.ops.intersect import pair_stats_tiles
from rabbittclust_tpu_torch.ops.pack import pack_sketches
from rabbittclust_tpu_torch.parallel import dist_engine as pde
from rabbittclust_tpu_torch.parallel import multihost as mh
from rabbittclust_tpu_torch.parallel.dryrun import (dryrun_corpus,
                                                   dryrun_multichip)

CPU = torch.device("cpu")
SHARDS = [1, 2, 3, 4, 8]
THRESHOLD = 0.05


def _ulp(a: float, b: float) -> int:
    return abs(int(np.float32(a).view(np.int32)) -
               int(np.float32(b).view(np.int32)))


def _assert_clear_of_threshold(hashes, kmer_size):
    """No pair's float64 Mash distance within 1e-5 of the threshold."""
    s = np.array([len(h) for h in hashes], dtype=np.float64)
    n = len(hashes)
    for i in range(n):
        for j in range(i):
            c = len(np.intersect1d(hashes[i], hashes[j]))
            if not c:
                continue
            jac = c / (s[i] + s[j] - c)
            d = 0.0 if jac >= 1 else -np.log(2 * jac / (1 + jac)) / kmer_size
            assert abs(d - THRESHOLD) > 1e-5, (i, j, d)


@pytest.fixture(scope="module")
def stats_corpora(synthetic_genomes):
    ss, p = sketch_files_kssd(synthetic_genomes.files[:16], min_len=1000,
                              kmer_size=19, drlevel=2)
    out = {"dryrun": (dryrun_corpus(8), 20),
           "genomes": (ss.hashes, p.kmer_size)}
    for hashes, k in out.values():
        _assert_clear_of_threshold(hashes, k)
    return out


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("corpus", ["dryrun", "genomes"])
def test_candidate_stats_equals_jax(corpus, k, stats_corpora):
    hashes, kmer = stats_corpora[corpus]
    n = len(hashes) - len(hashes) % k
    packed = jax_pack(hashes, use64=False, pad_n_to=n)
    assert np.array_equal(pack_sketches(hashes, False, pad_n_to=n).plane0,
                          packed.plane0)
    want = jde.distributed_candidate_stats(
        packed.plane0[:n], packed.sizes[:n], THRESHOLD, kmer,
        mesh=jde.make_mesh(k))
    got = pde.distributed_candidate_stats(
        packed.plane0[:n], packed.sizes[:n], THRESHOLD, kmer,
        mesh=pde.make_mesh(devices=[CPU] * k))
    ulp = _ulp(got[1], want[1])
    print(f"{corpus} k={k}: count {got[0]} (JAX {want[0]}), min "
          f"{got[1]!r} (JAX {want[1]!r}), {ulp} ulp apart")
    assert isinstance(got[0], int) and got[0] == want[0]
    assert ulp <= 4, (got, want)


def test_candidate_stats_refuses_a_ragged_mesh():
    packed = pack_sketches(dryrun_corpus(1)[:6], False, pad_n_to=6)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        pde.distributed_candidate_stats(packed.plane0, packed.sizes,
                                        THRESHOLD, 20,
                                        mesh=pde.make_mesh(devices=[CPU] * 4))


@pytest.mark.parametrize("t", [0, 1, 2])
def test_stats_tiles_plain_is_the_ring_step(t, stats_corpora):
    """The stats mode's plain version, over a step's tile kind (self:
    ``tri``; full; the antipodal step's lower shard: nothing), equals the
    JAX step with its ownership mask on the genome ids, for each step of a
    4-shard ring."""
    hashes, kmer = stats_corpora["dryrun"]
    packed = pack_sketches(hashes, False, pad_n_to=len(hashes))
    mesh = pde.make_mesh(devices=[CPU] * 4)
    shards = pde._plane_shards(packed.plane0, None, packed.sizes, mesh,
                               first_pad_id=len(hashes))
    radio = pde.size_ratio_limit(THRESHOLD, kmer - 1)
    rows = shards[0].p0.shape[0]
    for d in range(4):
        loc, vis = shards[d], shards[(d - t) % 4]
        want = pde.ring_stats_step_plain(loc, vis, t, 4, THRESHOLD, kmer,
                                         radio)
        kind = pde._step_kind(t, 4, loc.lo, vis.lo)
        got = pair_stats_tiles(loc.p0, loc.sizes, [0], [0],
                               [int(kind != "none")], radio, THRESHOLD,
                               kmer, rows, cols=(vis.p0, vis.sizes),
                               tri=kind == "self")
        assert got.tolist() == want.tolist(), (d, t, kind)


def test_shard_bounds_equals_jax():
    for n in (1, 7, 48, 50, 101):
        for np_ in (1, 2, 3, 5, 8):
            spans = [mh.shard_bounds(n, np_, p) for p in range(np_)]
            assert spans == [jmh.shard_bounds(n, np_, p)
                             for p in range(np_)], (n, np_)
            assert [g for lo, hi in spans for g in range(lo, hi)] == \
                list(range(n))


def test_transport_follows_the_layout():
    cuda = lambda *u: [("cuda", x) for x in u]  # noqa: E731
    assert mh._transport([[("cpu", "")] * 2] * 3) == "gloo"
    assert mh._transport([cuda("a"), cuda("b")]) == "nccl"
    assert mh._transport([cuda("a", "b"), cuda("c", "d")]) == "nccl"
    assert mh._transport([cuda("a"), cuda("a")]) == "gloo-staged"
    assert mh._transport([cuda("a", "a"), cuda("b", "b")]) == "gloo-staged"
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        mh._transport([cuda("a"), [("cpu", "")]])


@pytest.fixture
def one_rank():
    mesh = mh.init_multihost(f"127.0.0.1:{mh.free_port()}", 1, 0,
                             devices=[CPU] * 3)
    yield mesh
    mh.shutdown_multihost()


def test_allgather_ragged_is_byte_exact_single_proc(one_rank):
    """float64 / uint64 payloads survive the gloo allgather bit-exactly."""
    d = np.array([0.014936074231192451, 1e-300, -1.5], dtype=np.float64)
    (got,) = mh._allgather_ragged(d)
    assert got.tolist() == d.tolist() and got.dtype == np.float64
    u = np.array([2 ** 63 + 12345, 7], dtype=np.uint64)
    (gu,) = mh._allgather_ragged(u)
    assert gu.tolist() == u.tolist() and gu.dtype == np.uint64
    (ge,) = mh._allgather_ragged(np.empty(0, dtype=np.float64))
    assert ge.dtype == np.float64 and len(ge) == 0
    assert one_rank.size == 3 and one_rank.transport == "gloo"


def test_one_rank_ring_is_the_mesh_ring(one_rank):
    """With one process of 3 shards, the multi-process ring (the shared
    driver with the process shift) yields the single-process bitmap ring's
    candidates in its order."""
    hashes = mh._make_sim_sketches(48)
    got = mh.multihost_candidate_pairs_bitmap(hashes, 48, THRESHOLD, 21,
                                              bits=2048, mesh=one_rank)
    want = pde.distributed_candidate_pairs_bitmap(
        hashes, THRESHOLD, 21, mesh=pde.make_mesh(devices=[CPU] * 3),
        bits=2048)
    assert [a.tolist() for a in got] == [a.tolist() for a in want]
    assert mh.RING_LAST["hop_bytes"] == []  # one rank: nothing crosses


def _jax_results(n):
    """The JAX package's single-host engines on the simulation's inputs."""
    hashes = jmh._make_sim_sketches(n)
    res = compute_mst(hashes, THRESHOLD, 21)
    order = stdsort_size_desc(np.array([len(h) for h in hashes],
                                       dtype=np.int64))
    srt = [hashes[i] for i in order]
    sized = jmh._make_sim_sketches_sized(n)
    spread = jmh._make_sim_sketches_spread(n)
    db = {"plain": jdb.dbscan_cluster(hashes, THRESHOLD, 3, 21),
          "max_posting": jdb.dbscan_cluster(hashes, THRESHOLD, 3, 21,
                                            max_posting=32),
          "knn": jdb.dbscan_cluster(sized, THRESHOLD, 3, 21, knn_k=4),
          "minhash": jdb.minhash_dbscan_cluster(hashes, THRESHOLD, 3, 21),
          "containment": jdb.minhash_dbscan_cluster(
              hashes, THRESHOLD, 3, 21, is_containment=True),
          "spread": jdb.minhash_dbscan_cluster(spread, THRESHOLD, 2, 21,
                                               is_containment=True)}
    return hashes, res, order, srt, db


def _jax_repdb(hashes):
    """The JAX package's RepDB state of the simulation's corpus, and its
    queries (the child's RepDB block)."""
    from rabbittclust_tpu.sketch.base import SketchSet
    from rabbittclust_tpu.sketch.kssd import KssdParams
    from rabbittclust_tpu.state.greedy_state import KssdClusterState
    p = KssdParams.from_kmer_size(21, 3)
    ss = SketchSet("kssd", p, True, False)
    for i, h in enumerate(hashes):
        ss.append_genome(file_name=f"g{i}.fna", name=f"g{i}", comment="",
                         seq0_len=1000, total_len=1000, num_seqs=1, hashes=h)
    ss2 = ss.reorder(ss.kssd_greedy_order())
    st = KssdClusterState.from_clustering(
        ss2, p, jax_greedy(ss2.hashes, THRESHOLD, 21, presorted=True),
        THRESHOLD)
    return st, jmh._make_sim_sketches(len(hashes), seed=7)


@pytest.mark.parametrize("nproc,per,n", [(2, 2, 48), (3, 2, 50)])
def test_local_sim_equals_jax(nproc, per, n, tmp_path):
    outs = mh.launch_local_sim(nproc, per, n, device="cpu",
                               out_dir=str(tmp_path))
    assert len(outs) == nproc
    assert all(o.startswith("OK proc=") and f"devices={nproc * per}" in o
               for o in outs), outs
    assert len({o.split("digest=")[1] for o in outs}) == 1
    got = [pickle.load(open(tmp_path / f"proc{p}.pkl", "rb"))
           for p in range(nproc)]
    rings = [g.pop("ring") for g in got]  # each process's own hop times
    assert all(g == got[0] for g in got[1:]), "processes disagree"
    got = got[0]
    for maker in ("_make_sim_sketches", "_make_sim_sketches_sized",
                  "_make_sim_sketches_spread"):
        assert all(np.array_equal(a, b) for a, b in zip(
            getattr(mh, maker)(n), getattr(jmh, maker)(n)))
    hashes, res, order, srt, db = _jax_results(n)
    want = clusters_from_forest(cut_forest(res.mst, THRESHOLD), n)
    assert sorted(sorted(c) for c in got["partition"]) == \
        sorted(sorted(c) for c in want)
    assert got["mst_cut"] == [a.tolist() for a in cut_forest(res.mst,
                                                              THRESHOLD)]
    assert got["leiden"] == community_clusters(hashes, THRESHOLD, 21)
    hf, ht, hw = build_similarity_graph(hashes, THRESHOLD, 21)
    assert sorted(zip(*got["graph"])) == sorted(zip(hf.tolist(), ht.tolist(),
                                                    hw.tolist()))
    assert got["greedy_order"] == order.tolist()
    assert got["greedy"] == jax_greedy(srt, THRESHOLD, 21,
                                       presorted=True).clusters
    assert got["greedy_containment"] == jax_greedy(
        srt, THRESHOLD, 21, presorted=True, is_containment=True).clusters
    for name, ref in db.items():
        mine = got["dbscan"][name]
        assert mine["labels"] == ref.labels.tolist(), name
        assert mine["clusters"] == ref.clusters, name
        assert mine["noise"] == ref.noise, name
    st, queries = _jax_repdb(hashes)
    assert got["repdb_query"] == [st.query_topk(q, 3) for q in queries]
    assert got["repdb_assign"] == [st.assign(q) for q in queries]
    for ring in rings:
        assert ring["transport"] == "gloo" and ring["n_dev"] == nproc * per
        assert len(ring["hop_bytes"]) == pde._n_ring_steps(nproc * per) - 1


def test_local_sim_children_are_killed_at_the_timeout():
    with pytest.raises(RuntimeError, match="timed out") as info:
        mh.launch_local_sim(2, 2, 48, timeout=0.5, device="cpu")
    # run_ranks killed and reaped both children
    assert isinstance(info.value.__cause__, mh.RanksTimedOut)
    assert info.value.__cause__.returncodes == [-signal.SIGKILL] * 2


def test_run_ranks_returns_each_ranks_output():
    cmds = [[sys.executable, "-c",
             f"import sys; print('out{i}'); print('err{i}', file=sys.stderr);"
             f" sys.exit({i})"] for i in range(3)]
    rcs, outs, errs = mh.run_ranks(cmds, timeout=120)
    assert rcs == [0, 1, 2]
    assert outs == [f"out{i}\n" for i in range(3)]
    assert errs == [f"err{i}\n" for i in range(3)]


def test_run_ranks_reaps_every_rank_at_its_timeout():
    """A rank that ends in time is reaped with its own code; the others are
    killed at the deadline and reaped before the error is raised."""
    cmds = [[sys.executable, "-c", "import time; time.sleep(120)"],
            [sys.executable, "-c", "print('quick')"],
            [sys.executable, "-c", "import time; time.sleep(120)"]]
    t0 = time.monotonic()
    with pytest.raises(mh.RanksTimedOut) as info:
        mh.run_ranks(cmds, timeout=5.0)
    assert time.monotonic() - t0 < 60
    assert info.value.returncodes == [-signal.SIGKILL, 0, -signal.SIGKILL]


def test_dryrun_multichip_cpu_shards():
    out = dryrun_multichip(4, devices=[CPU] * 4)
    hashes = dryrun_corpus(4)
    packed = jax_pack(hashes, use64=False, pad_n_to=len(hashes))
    want = jde.distributed_candidate_stats(
        packed.plane0, packed.sizes, THRESHOLD, 20, mesh=jde.make_mesh(4))
    assert out["total"] == want[0] and _ulp(out["min_d"], want[1]) <= 4
    assert out["bitmap_clusters"] == out["lp_clusters"]
    assert len(out["sim"]) == 2


def test_dryrun_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    monkeypatch.delenv("RTC_VIRTUAL_CPU_DEVICES", raising=False)
    with pytest.raises(RuntimeError, match="RTC_VIRTUAL_CPU_DEVICES"):
        mh.local_devices(0)
    monkeypatch.setenv("RTC_VIRTUAL_CPU_DEVICES", "3")
    assert mh.local_devices(0) == [CPU] * 3

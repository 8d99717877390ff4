"""The port's mesh engines (``parallel/dist_engine.py``) on the CPU against
the JAX package's, shard for shard: the JAX mesh is ``make_mesh(k)`` over
the conftest's 8 virtual CPU devices, the port's ``make_mesh(devices=[cpu]
* k)``, for k in 1, 2, 3, 4 and 8.  The shard geometry is JAX's, so the
candidate lists are compared in order, the MSTs byte for byte and the
clusters as lists; the CLI under ``RTC_MESH=1`` writes the JAX CLI's
``edge.mst`` and ``.cluster`` bytes."""

from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabbittclust_tpu.cli.clust_mst import main as jax_main
from rabbittclust_tpu.ops.labelprop import SENT as JAX_SENT
from rabbittclust_tpu.parallel import dist_engine as jde
from rabbittclust_tpu_torch import workflows as port_wf
from rabbittclust_tpu_torch.cli.clust_mst import main as port_main
from rabbittclust_tpu_torch.ops import bitmap as bm
from rabbittclust_tpu_torch.ops.labelprop import SENT
from rabbittclust_tpu_torch.ops.pack import (compact_of, compact_planes,
                                            keep_compact, pack_sketches)
from rabbittclust_tpu_torch.parallel import dist_engine as pde
from torch_port_data import clear_list, clustered_sketches

CPU = torch.device("cpu")
SHARDS = [1, 2, 3, 4, 8]


def _meshes(k):
    jm = jde.make_mesh(k)
    assert jm.devices.size == k
    return jm, pde.make_mesh(devices=[CPU] * k)


def _lp_corpus(n, n_bases, s_base, s):
    """The corpora of tests/test_mesh_workflow.py's two mesh LP tests."""
    rng = np.random.default_rng(21 if n == 420 else 9)
    bases = [np.unique(rng.integers(0, 2 ** 29, size=s_base).astype(
        np.uint32)) for _ in range(n_bases)]
    hashes = []
    for i in range(n):
        b = bases[i % n_bases]
        keep = b[rng.random(len(b)) < 0.8]
        extra = np.unique(rng.integers(
            0, 2 ** 29, size=s - len(keep)).astype(np.uint32))
        hashes.append(np.unique(np.concatenate([keep, extra])))
    return hashes


LP_CORPORA = {"planted420": (lambda: _lp_corpus(420, 11, 150, 170), 2048),
              "false_positives160": (lambda: _lp_corpus(160, 8, 60, 70),
                                     128)}


def _corpus(use64=False, n=150):
    return clustered_sketches(n=n, s=120, n_clusters=9, seed=17,
                              dtype=np.uint64 if use64 else np.uint32,
                              keep=0.8)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_ring_schedule_and_mesh():
    for k in range(1, 9):
        assert pde._n_ring_steps(k) == jde._n_ring_steps(k)
        ids = np.arange(6)
        for t in range(pde._n_ring_steps(k)):
            # t is traced in the JAX ring
            want = np.asarray(jde._ownership_mask(jnp.int32(t), k, ids,
                                                  ids[::-1]))
            got = pde._ownership_mask(t, k, torch.from_numpy(ids),
                                      torch.from_numpy(ids[::-1].copy()))
            assert np.array_equal(got.numpy(), want)
    mesh = pde.make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and not mesh.cuda
    assert pde.make_mesh(2, devices=[CPU] * 4).size == 2
    with pytest.raises(ValueError):
        pde.make_mesh(devices=[])
    assert pde.ring_comm_stats(1024, 4, 256) == \
        jde.ring_comm_stats(1024, 4, 256)
    assert pde.dist_lp_comm_stats(1024, 4, 2048, 3) == \
        jde.dist_lp_comm_stats(1024, 4, 2048, 3)


def test_moved_shard_keeps_its_compact_form():
    """A shard copied to another device takes its compact form along
    (``PlaneShard.to``): ``keep_compact`` records the copied form, which
    ``compact_of`` then returns for the new planes; it equals a fresh
    build.  On one device the shard stays the same tensors."""
    pk = pack_sketches(_corpus(), False, pad_n_to=128)
    p0 = torch.from_numpy(pk.plane0.view(np.int32))
    form = compact_of(p0, None)
    assert compact_of(p0, None) is form
    moved = p0.clone()
    kept = keep_compact(moved, None, form.to(CPU))
    assert compact_of(moved, None) is kept
    fresh = compact_planes(moved, None)
    for f in fields(fresh):
        a, b = getattr(kept, f.name), getattr(fresh, f.name)
        assert (a is None and b is None) or (
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    sizes = torch.from_numpy(pk.sizes.astype(np.int32))
    shard = pde.PlaneShard(p0, None, sizes, 0)
    assert shard.to(CPU).p0 is p0


@pytest.mark.parametrize("k", SHARDS)
def test_candidate_pairs_bitmap_equal_jax(k):
    hashes = _corpus()
    jm, pm = _meshes(k)
    for cont in (False, True):
        _equal(jde.distributed_candidate_pairs_bitmap(
                   hashes, 0.05, 21, is_containment=cont, mesh=jm, bits=1024),
               pde.distributed_candidate_pairs_bitmap(
                   hashes, 0.05, 21, is_containment=cont, mesh=pm,
                   bits=1024))
    # radio 0: no size-ratio gate
    _equal(jde.distributed_candidate_pairs_bitmap(hashes, 0.05, 21, mesh=jm,
                                                  bits=1024, radio=0),
           pde.distributed_candidate_pairs_bitmap(hashes, 0.05, 21, mesh=pm,
                                                  bits=1024, radio=0))


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2planes"])
@pytest.mark.parametrize("k", SHARDS)
def test_candidate_edges_equal_jax(k, use64):
    hashes = _corpus(use64, n=90)
    jm, pm = _meshes(k)
    p0, p1, sizes = jde._pack_rows_for_mesh(hashes, jm)
    q0, q1, qs = pde._pack_rows_for_mesh(hashes, pm)
    assert np.array_equal(p0, q0) and np.array_equal(sizes, qs)
    assert (p1 is None) == (q1 is None) == (not use64)
    _equal(jde.distributed_candidate_edges(p0, sizes, 0.05, 21, mesh=jm,
                                           packed_plane1=p1),
           pde.distributed_candidate_edges(p0, sizes, 0.05, 21, mesh=pm,
                                           packed_plane1=p1))


@pytest.mark.parametrize("engine", ["exact", "bitmap"])
@pytest.mark.parametrize("k", SHARDS)
def test_distributed_mst_equal_jax(k, engine):
    hashes = _corpus(n=120)
    jm, pm = _meshes(k)
    want = jde.distributed_mst(hashes, 0.05, 21, mesh=jm, engine=engine,
                               bits=1024)
    got = pde.distributed_mst(hashes, 0.05, 21, mesh=pm, engine=engine,
                              bits=1024)
    assert got.n == want.n
    _equal(want.mst, got.mst)
    assert got.mst[2].tobytes() == want.mst[2].tobytes()


@pytest.mark.parametrize("k", SHARDS)
def test_threshold_clusters_and_graph_equal_jax(k):
    hashes = _corpus()
    jm, pm = _meshes(k)
    for cont in (False, True):
        assert pde.distributed_threshold_clusters(
            hashes, 0.05, 21, is_containment=cont, mesh=pm, bits=1024) == \
            jde.distributed_threshold_clusters(
                hashes, 0.05, 21, is_containment=cont, mesh=jm, bits=1024)
    _equal(jde.distributed_similarity_graph(hashes, 0.05, 21, mesh=jm,
                                            bits=1024),
           pde.distributed_similarity_graph(hashes, 0.05, 21, mesh=pm,
                                            bits=1024))


@pytest.mark.parametrize("corpus", list(LP_CORPORA))
@pytest.mark.parametrize("k", SHARDS)
def test_threshold_clusters_lp_equal_jax(k, corpus):
    make, bits = LP_CORPORA[corpus]
    hashes = make()
    jm, pm = _meshes(k)
    want = jde.distributed_threshold_clusters_lp(hashes, 0.05, 21, mesh=jm,
                                                 bits=bits)
    got = pde.distributed_threshold_clusters_lp(hashes, 0.05, 21, mesh=pm,
                                                bits=bits)
    assert got == want
    assert pde.DIST_LP_LAST["rounds"] == jde.DIST_LP_LAST["rounds"]


def test_lp_max_rounds_fallback_equal_jax():
    """Past ``max_rounds`` both finish from the pulled slabs."""
    hashes = LP_CORPORA["false_positives160"][0]()
    jm, pm = _meshes(4)
    want = jde.distributed_threshold_clusters_lp(hashes, 0.05, 21, mesh=jm,
                                                 bits=128, max_rounds=1)
    got = pde.distributed_threshold_clusters_lp(hashes, 0.05, 21, mesh=pm,
                                                bits=128, max_rounds=1)
    assert got == want and pde.DIST_LP_LAST["rounds"] == 1


def test_dist_lp_round_equals_jax():
    """The mask ring's slabs and one round (a clear list whose (step, row,
    byte) targets repeat) equal JAX's build and dist_lp_round_fn."""
    from rabbittclust_tpu.distance.mash import min_jaccard_for_threshold
    assert SENT == JAX_SENT
    hashes = LP_CORPORA["planted420"][0]()
    k = 4
    jm, pm = _meshes(k)
    n = len(hashes)
    xp, coll = bm.pack_bitmaps_packed(hashes, bits=2048, pad_n_to=k * 128)
    n_pad = xp.shape[0]
    shard = n_pad // k
    n_steps = pde._n_ring_steps(k)
    sizes = np.zeros(n_pad, dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    j_min = min_jaccard_for_threshold(0.05, 21)
    scalars = bm.filter_scalars(0.05, 21)
    build, rnd = jde._jitted_dist_lp(jm, j_min, 1.0 + j_min,
                                     float(scalars[2]), int(scalars[3]),
                                     False)
    masks = build(jnp.asarray(xp), jnp.asarray(coll), jnp.asarray(sizes),
                  jnp.asarray(np.arange(n_pad, dtype=np.int32)))
    slabs = pde.build_ring_masks(pm, pde._bit_shards(xp, coll, sizes, pm),
                                 scalars[:3], int(scalars[3]), False)
    want_masks = np.asarray(masks).reshape(k, n_steps, shard, shard // 8)
    for d in range(k):
        assert np.array_equal(slabs[d].numpy(), want_masks[d]), d
    rng = np.random.default_rng(4)
    clrs = [clear_list(want_masks[d], rng) for d in range(k)]
    labels = rng.integers(0, 60, n_pad).astype(np.int32)
    masks, row_p, fused = rnd(masks, jnp.asarray(labels),
                              jnp.asarray(np.concatenate(
                                  [c.reshape(-1) for c in clrs])))
    got_row, got_fused = pde.dist_lp_round(
        pm, slabs, {CPU: torch.from_numpy(labels)},
        [torch.from_numpy(c) for c in clrs])
    assert np.array_equal(got_row.numpy(), np.asarray(row_p))
    assert np.array_equal(got_fused.numpy(), np.asarray(fused))
    cleared = np.asarray(masks).reshape(want_masks.shape)
    for d in range(k):
        assert np.array_equal(slabs[d].numpy(), cleared[d]), d


# ---------------------------------------------------------------------------
# The CLI route: RTC_MESH

def _run_cli(tmp_path, monkeypatch, argv, port_shards, env):
    """Both CLIs under ``env``; the port's mesh is ``port_shards`` CPU
    devices (the JAX CLI takes the conftest's 8).  Returns {side: dir}."""
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(port_wf, "mesh_devices",
                        lambda device: [device] * port_shards)
    out = {}
    for side, fn in (("jax", jax_main), ("port", port_main)):
        wd = tmp_path / side
        wd.mkdir()
        monkeypatch.chdir(wd)
        kw = {"device": CPU} if side == "port" else {}
        assert fn(argv + ["-o", str(wd / "out.cluster")], **kw) == 0
        out[side] = wd
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _run_folder(wd):
    runs = [p for p in wd.iterdir() if p.is_dir()]
    assert len(runs) == 1
    return runs[0]


@pytest.mark.parametrize("port_shards", [1, 3])
def test_cli_mesh_exact_ring_byte_equal(synthetic_genomes, tmp_path,
                                        monkeypatch, capsys, port_shards):
    """Default saves: the exact ring; edge.mst and .cluster byte-equal."""
    argv = ["--fast", "--device", "-l", "-i", synthetic_genomes.list_file,
            "-d", "0.05", "--drlevel", "2", "-m", "1000"]
    res = _run_cli(tmp_path, monkeypatch, argv, port_shards,
                   {"RTC_MESH": "1"})
    err = capsys.readouterr().err
    assert "8-device mesh ring engine (exact)" in err
    assert f"{port_shards}-device mesh ring engine (exact)" in err
    assert _bytes(res["jax"] / "out.cluster") == \
        _bytes(res["port"] / "out.cluster")
    assert _bytes(_run_folder(res["jax"]) / "edge.mst") == \
        _bytes(_run_folder(res["port"]) / "edge.mst")


def test_cli_mesh_bitmap_ring_byte_equal(synthetic_genomes, tmp_path,
                                         monkeypatch, capsys):
    """``-e`` with the MST engine kept (RTC_MST_CLUSTERS_FAST=0): the
    bitmap ring; the .cluster byte-equal."""
    argv = ["--fast", "--device", "-l", "-i", synthetic_genomes.list_file,
            "-d", "0.05", "--drlevel", "2", "-m", "1000", "-e"]
    res = _run_cli(tmp_path, monkeypatch, argv, 8,
                   {"RTC_MESH": "1", "RTC_MST_CLUSTERS_FAST": "0"})
    assert capsys.readouterr().err.count("mesh ring engine (bitmap)") == 2
    assert _bytes(res["jax"] / "out.cluster") == \
        _bytes(res["port"] / "out.cluster")


def test_cli_mesh_minhash_byte_equal(synthetic_genomes, tmp_path,
                                     monkeypatch, capsys):
    """MinHash clust-mst (64-bit hashes: the exact ring on two planes)."""
    argv = ["--device", "-l", "-i", synthetic_genomes.list_file, "-d",
            "0.05"]
    res = _run_cli(tmp_path, monkeypatch, argv, 4, {"RTC_MESH": "1"})
    assert capsys.readouterr().err.count("mesh ring engine (exact)") == 2
    assert _bytes(res["jax"] / "out.cluster") == \
        _bytes(res["port"] / "out.cluster")
    assert _bytes(_run_folder(res["jax"]) / "edge.mst") == \
        _bytes(_run_folder(res["port"]) / "edge.mst")


@pytest.mark.parametrize("env,extra", [({"RTC_MESH": "0"}, []),
                                       ({"RTC_MESH": "auto"}, []),
                                       ({"RTC_MESH": "1"}, ["--dense"])],
                         ids=["mesh0", "auto_one_device", "dense"])
def test_cli_single_device_engine_kept(synthetic_genomes, tmp_path,
                                       monkeypatch, capsys, env, extra):
    """RTC_MESH=0, auto with one device, and --dense (RTC_MESH=1) keep the
    dense engine; the port never enters the ring."""
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    monkeypatch.chdir(tmp_path)
    pde.reset_launches()
    called = []
    real = pde.distributed_mst
    monkeypatch.setattr(pde, "distributed_mst",
                        lambda *a, **kw: called.append(1) or real(*a, **kw))
    assert port_main(["--fast", "--device", "-l", "-i",
                      synthetic_genomes.list_file, "-d", "0.05",
                      "--drlevel", "2", "-m", "1000", "-o",
                      str(tmp_path / "o.cluster")] + extra,
                     device=CPU) == 0
    assert not called
    assert "using the dense MST engine" in capsys.readouterr().err


def test_mesh_devices_seam():
    """``mesh_devices`` picks the mesh: every visible CUDA device on the
    card, the caller's CPU device otherwise."""
    assert port_wf.mesh_devices(CPU) == [CPU]

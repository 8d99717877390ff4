"""Kernels K1 / K2 / K3 / K4 (counts and mask modes) / K5b / K6 / K7 / K8,
the mesh ring steps and the port's engines on the card, against their
plain torch versions and the native host engine.  Marked ``cuda``; every test skips inside itself when no GPU
is visible.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from rabbittclust_tpu_torch.cluster.mst import (
    clusters_from_forest,
    compute_mst,
    cut_forest,
)
from rabbittclust_tpu_torch.ops import bitmap as bm
from rabbittclust_tpu_torch.ops import cluster_fast, engine
from rabbittclust_tpu_torch.ops import intersect as ix
from rabbittclust_tpu_torch.ops import labelprop as lp
from rabbittclust_tpu_torch.ops.pack import pack_sketches, planes_to_device
from torch_port_data import clear_list, clustered_sketches, \
    containment_sketches, dense_keep_table, kssd_window, planted_tokens, \
    shared_sketches, stats_division_operands, write_scale_genomes

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _planes(n, s, use64, device, bucket_bits=None, pad_n_to=128, seed=3):
    dtype = np.uint64 if use64 else np.uint32
    hashes = clustered_sketches(n=n, s=s, n_clusters=max(n // 40, 1),
                                seed=seed, dtype=dtype, keep=0.8)
    pk = pack_sketches(hashes, use64, bucket_bits=bucket_bits,
                       pad_n_to=pad_n_to)
    return hashes, pk, planes_to_device(pk, device)


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
@pytest.mark.parametrize("bucket_bits", [None, 3], ids=["W_natural", "W_wide"])
def test_k4_matches_plain_small_ragged(gpu, use64, bucket_bits):
    _, pk, pl = _planes(300, 150, use64, gpu, bucket_bits=bucket_bits)
    rb = 128
    r0s, c0s, val = [0, 128, 256, 256, 0], [0, 0, 128, 256, 0], [1] * 4 + [0]
    before = ix.LAUNCHES["pair_counts_tiles"]
    got = ix.pair_counts_tiles(pl.plane0, pl.plane1, r0s, c0s, val, rb)
    torch.cuda.synchronize()
    assert ix.LAUNCHES["pair_counts_tiles"] == before + 1
    for t in range(4):
        a, b = slice(r0s[t], r0s[t] + rb), slice(c0s[t], c0s[t] + rb)
        want = ix.pair_counts_plain(
            pl.plane0[a], pl.plane0[b],
            None if pl.plane1 is None else pl.plane1[a],
            None if pl.plane1 is None else pl.plane1[b])
        assert torch.equal(got[t], want), (t, pk.width)


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
def test_k4_matches_plain_slice_shape(gpu, use64):
    """W = 12, K = 1024, rb = 4096: one tile, compared in 512-row slices."""
    _, pk, pl = _planes(8192, 1000, use64, gpu, pad_n_to=4096, seed=7)
    assert pk.k == 1024
    rb = 4096
    got = ix.pair_counts_tiles(pl.plane0, pl.plane1, [4096], [0], [1], rb)[0]
    for s in range(0, rb, 512):
        a, b = slice(4096 + s, 4096 + s + 512), slice(0, rb)
        want = ix.pair_counts_plain(
            pl.plane0[a], pl.plane0[b],
            None if pl.plane1 is None else pl.plane1[a],
            None if pl.plane1 is None else pl.plane1[b])
        assert torch.equal(got[s:s + 512], want), s


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
def test_k5b_matches_plain(gpu, use64):
    _, pk, pl = _planes(2048, 1000, use64, gpu)
    rng = np.random.default_rng(1)
    ii = rng.integers(0, 2048, size=100_000)
    jj = rng.integers(0, 2048, size=100_000)
    got = ix.pair_common(pl.plane0, pl.plane1, ii, jj)
    want = ix.pair_common_plain(pl.plane0, pl.plane1,
                                torch.from_numpy(ii).to(gpu),
                                torch.from_numpy(jj).to(gpu))
    assert torch.equal(got, want)
    assert int(want.max()) > 0


def test_wrapper_rejects_bad_planes(gpu):
    bad = torch.zeros((64, 6, 64), dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="W % 4"):
        ix.pair_counts_tiles(bad, None, [0], [0], [1], 32)
    with pytest.raises(ValueError, match="int32"):
        ix.pair_common(bad.float(), None, [0], [1])
    _, _, pl = _planes(300, 150, False, gpu)
    with pytest.raises(ValueError, match="multiple of 128"):
        ix.pair_counts_tiles(pl.plane0, None, [0], [0], [1], 64)
    with pytest.raises(ValueError, match="origins"):
        ix.pair_counts_tiles(pl.plane0, None, [64], [0], [1], 128)


MASK_CASES = [(0, 300), (150, 290), (37, 211)]


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
@pytest.mark.parametrize("start,n", MASK_CASES,
                         ids=["whole", "start_and_ragged_n", "ragged_n"])
def test_k4_mask_matches_plain_epilogue(gpu, use64, start, n):
    """K4's mask mode against the plain epilogue over the plain counts:
    masks and per-tile counts byte-equal, diagonal, off-diagonal and
    padded-tail tiles, an invalid slot, start_index and a ragged n
    cutting through tiles."""
    _, pk, pl = _planes(300, 150, use64, gpu)
    r0s, c0s, val = [0, 128, 256, 256, 128, 0], [0, 0, 128, 256, 128, 0], \
        [1] * 5 + [0]
    radio = 44
    before = ix.LAUNCHES["pair_mask_tiles"]
    cnt, packs = ix.pair_mask_tiles(pl.plane0, pl.plane1, pl.sizes, r0s, c0s,
                                    val, radio, start, n, 128)
    torch.cuda.synchronize()
    assert ix.LAUNCHES["pair_mask_tiles"] == before + 1
    counts = ix._pair_counts_tiles_plain(pl.plane0, pl.plane1, r0s, c0s, val,
                                         128)
    want_c, want_p = ix.mask_epilogue(counts, pl.sizes, r0s, c0s, val, radio,
                                      start, n, 128)
    assert torch.equal(cnt, want_c)
    assert torch.equal(packs, want_p)
    assert int(want_c.sum()) > 0
    assert int(np.unpackbits(packs.cpu().numpy()).sum()) == int(cnt.sum())


@pytest.mark.parametrize("use64", [False, True], ids=["1plane", "2plane"])
def test_k4_counts_diagonal_padded_tail(gpu, use64):
    """A diagonal tile whose last 84 rows are padding: the diagonal holds
    each genome's pad self-matches (W^2 K on the tail) as the plain form
    counts them."""
    _, pk, pl = _planes(300, 150, use64, gpu)
    got = ix.pair_counts_tiles(pl.plane0, pl.plane1, [256], [256], [1], 128)
    a = slice(256, 384)
    want = ix.pair_counts_plain(
        pl.plane0[a], pl.plane0[a], None if pl.plane1 is None else
        pl.plane1[a], None if pl.plane1 is None else pl.plane1[a])
    assert torch.equal(got[0], want)
    w, k = pk.width, pk.k
    assert (want.diagonal()[300 - 256:] == w * w * k).all()


@pytest.mark.parametrize("use64,mode", [
    (False, "counts"), (True, "counts"), (False, "mask"), (True, "mask"),
    (False, "stats")])
@pytest.mark.parametrize("bucket_bits", [None, 3],
                         ids=["W_natural", "W_wide"])
def test_k4_long_equal_runs_match_plain(gpu, use64, mode, bucket_bits):
    """K4's sorted join where one value fills a bucket's run across all
    128 genomes of a group (``shared_sketches``: 300 genomes, a ragged
    tail group), in each mode against its plain version: the counts, the
    masks and tile counts, the stats (count equal, minimum within 4 ulp).
    W_wide (bucket_bits=3) makes a bucket's segment longer than a window
    holds under the staging budget, so the kernel stages one bucket a
    window in a larger ring."""
    hashes = shared_sketches(n=300, dtype=np.uint64 if use64 else
                             np.uint32)
    pk = pack_sketches(hashes, use64, bucket_bits=bucket_bits,
                       pad_n_to=128)
    pl = planes_to_device(pk, gpu)
    cf = pl.compact()
    if bucket_bits == 3:
        wb, _, smem = ix.tile_config(cf, use64, ix.COUNTS)
        assert wb == 1 and smem - 4 * 128 * 128 > ix.STAGE_BUDGET
    r0s, c0s, val = [0, 128, 256, 256, 0], [0, 0, 128, 256, 0], [1] * 4 + [0]
    counts = ix._pair_counts_tiles_plain(pl.plane0, pl.plane1, r0s, c0s, val,
                                         128)
    assert int(counts[0].min()) >= 6  # the values every genome holds
    if mode == "counts":
        got = ix.pair_counts_tiles(pl.plane0, pl.plane1, r0s, c0s, val, 128)
        assert all(torch.equal(got[t], counts[t]) for t in range(4))
    elif mode == "mask":
        args = (r0s, c0s, val, 44, 37, 290, 128)
        cnt, packs = ix.pair_mask_tiles(pl.plane0, pl.plane1, pl.sizes,
                                        *args)
        want_c, want_p = ix.mask_epilogue(counts, pl.sizes, *args)
        assert torch.equal(cnt, want_c) and torch.equal(packs, want_p)
        assert int(want_c.sum()) > 0
    else:  # j < i: the full steps' stats are the ring test's
        got = ix.pair_stats_tiles(pl.plane0, pl.sizes, r0s, c0s, val, 44,
                                  0.05, 21, 128)
        want = ix.pair_stats_tiles_plain(pl.plane0, pl.sizes, r0s, c0s, val,
                                         44, 0.05, 21, 128)
        assert int(got[0]) == int(want[0]) > 0
        assert _ulp_apart(got, want) <= 4


def test_stats_division_is_ieee(gpu):
    """The stats epilogue's divisions (``div_rn_normal``: IEEE's sequence
    without its range check's slow path) bit-equal to IEEE float32
    division (numpy's) over the operands the epilogue can give them:
    common (0 included) over max(denom, 1) up to 2^32, and 2j / (1 + j)
    with j near 2^-32 and near 1."""
    a, b = stats_division_operands()
    assert a.max() > 2 ** 30 and b.max() > 2 ** 31 and (a == 0).any()
    got = ix.stats_division(torch.from_numpy(a).to(gpu),
                            torch.from_numpy(b).to(gpu)).cpu().numpy()
    want = a / b
    bad = np.flatnonzero(got.view(np.int32) != want.view(np.int32))
    assert len(bad) == 0, [(a[i], b[i], got[i], want[i]) for i in bad[:5]]


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
def test_exact_ring_steps_long_runs_match_plain(gpu, use64):
    """The exact ring's steps (K4's mask mode with the visiting shard's
    column form, K3, K5b) and the stats ring's over 3 shards of the
    ``shared_sketches`` corpus on [cuda:0] * 3: the self step and the full
    steps against the plain steps, exact (the stats: count equal, minimum
    within 4 ulp; one plane)."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    mesh = de.make_mesh(devices=[gpu] * 3)
    hashes = shared_sketches(n=330, dtype=np.uint64 if use64 else
                             np.uint32)
    p0, p1, sz = de._pack_rows_for_mesh(hashes, mesh)
    shards = de._plane_shards(p0, p1, sz, mesh, p0.shape[0])
    radio = de.size_ratio_limit(0.05, 20)
    kinds = set()
    for d in range(3):
        for t in range(de._n_ring_steps(3)):
            loc, vis = shards[d], shards[(d - t) % 3]
            kinds.add(de._step_kind(t, 3, loc.lo, vis.lo))
            got = de.ring_edges_step(loc, vis, t, 3, radio)
            want = de.ring_edges_step_plain(loc, vis, t, 3, radio)
            assert torch.equal(got[0], want[0]), (d, t)
            assert torch.equal(got[1], want[1]), (d, t)
            assert len(want[0]) > 0
            if use64:
                continue
            got = de.ring_stats_step(loc, vis, t, 3, 0.05, 21, radio)
            want = de.ring_stats_step_plain(loc, vis, t, 3, 0.05, 21, radio)
            assert int(got[0]) == int(want[0]), (d, t)
            assert _ulp_apart(got, want) <= 4, (d, t)
    assert kinds == {"self", "full"}


@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
@pytest.mark.parametrize("s", [150, 1000], ids=["staged", "in_place"])
def test_k5b_matches_plain_w_wide(gpu, use64, s):
    """Wide buckets (bucket_bits=3), a padded tail and pairs of a genome
    with itself (the pad term); at 1,000 hashes a genome's step of 128
    buckets holds more entries than K5b stages, so it reads them in
    place."""
    _, pk, pl = _planes(300, s, use64, gpu, bucket_bits=3)
    assert pk.width > 16
    rng = np.random.default_rng(4)
    ii = rng.integers(0, pk.n, size=20_000)
    jj = rng.integers(0, pk.n, size=20_000)
    jj[:500] = ii[:500]
    got = ix.pair_common(pl.plane0, pl.plane1, ii, jj)
    want = ix.pair_common_plain(pl.plane0, pl.plane1,
                                torch.from_numpy(ii).to(gpu),
                                torch.from_numpy(jj).to(gpu))
    assert torch.equal(got, want)


def test_engine_on_card_matches_host(gpu):
    hashes = clustered_sketches(n=3000, s=400, n_clusters=30, seed=5)
    ix.reset_launches()
    stats = {}
    got = engine.compute_mst_device(hashes, 0.05, 21, device=gpu,
                                    with_dense=True, stats=stats)
    assert ix.LAUNCHES["pair_mask_tiles"] > 0
    assert ix.LAUNCHES["pair_common"] > 0
    assert ix.LAUNCHES["pair_counts_tiles"] == 0  # no counts in memory
    want = compute_mst(hashes, 0.05, 21, with_dense=True)
    n = len(hashes)
    assert len(got.mst[0]) == len(want.mst[0])
    np.testing.assert_allclose(np.sort(got.mst[2]), np.sort(want.mst[2]),
                               rtol=1e-12, atol=0)
    part = [sorted(c) for c in clusters_from_forest(cut_forest(got.mst,
                                                               0.05), n)]
    ref = [sorted(c) for c in clusters_from_forest(cut_forest(want.mst,
                                                              0.05), n)]
    assert sorted(part) == sorted(ref)
    assert np.array_equal(got.ani, want.ani)
    assert stats["sweep_ms"] > 0


def _signatures(hashes, bits, rb, device, bound="mst"):
    sizes = [len(h) for h in hashes]
    return bm.stage_signatures(hashes, bits, rb, device, bound,
                               col_sizes=sizes[::-1])


TILES = ([0, 128, 256, 256, 0], [0, 0, 128, 256, 0], [1, 1, 1, 1, 0])


@pytest.mark.parametrize("bound", ["mst", "greedy", "minhash"])
@pytest.mark.parametrize("containment", [False, True], ids=["mash", "aaf"])
@pytest.mark.parametrize("use64", [False, True], ids=["32bit", "64bit"])
def test_k1_matches_plain_small_ragged(gpu, bound, containment, use64):
    """300 genomes padded to 384 (a padded last row block), diagonal and
    off-diagonal tiles and a valid == 0 slot."""
    hashes = containment_sketches(300) if containment else \
        clustered_sketches(n=300, dtype=np.uint64 if use64 else np.uint32)
    sig = _signatures(hashes, 1024, 128, gpu, bound)
    sc = bm.filter_scalars(0.05, 21, bound)
    before = bm.LAUNCHES["filter_mask"]
    got = bm.batched_mask(sig.xd, sig.cd, sig.sd, *TILES, *sc,
                          containment, 128, bound)
    torch.cuda.synchronize()
    assert bm.LAUNCHES["filter_mask"] == before + 1
    want = bm.batched_mask_plain(sig.xd, sig.cd, sig.sd,
                                 *map(np.asarray, TILES), *sc, containment,
                                 128, bound)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert int(want[0].sum()) > 0


def test_k1_matches_plain_slice_shape(gpu):
    """rb = 4096, 8192 bits: a diagonal and an off-diagonal tile."""
    hashes = clustered_sketches(n=8000, s=1000, n_clusters=64, seed=7)
    sig = _signatures(hashes, 8192, 4096, gpu)
    sc = bm.filter_scalars(0.05, 22)
    tiles = ([4096, 4096, 0], [0, 4096, 0], [1, 1, 0])
    got = bm.batched_mask(sig.xd, sig.cd, sig.sd, *tiles, *sc, False, 4096)
    want = bm.batched_mask_plain(sig.xd, sig.cd, sig.sd,
                                 *map(np.asarray, tiles), *sc, False, 4096)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[0][0]) > 0


@pytest.mark.parametrize("bound", ["mst", "greedy", "minhash"])
@pytest.mark.parametrize("containment", [False, True], ids=["mash", "aaf"])
@pytest.mark.parametrize("rb,bits", [(96, 64), (160, 128), (96, 8192),
                                     (160, 1024)])
def test_k1_matches_plain_ragged_rb_small_bits(gpu, rb, bits, bound,
                                               containment):
    """rb not a multiple of the 128-pair block tile, and signatures shorter
    than one 256-bit stage: 300 genomes padded to whole row blocks, a
    diagonal tile with padded rows, an off-diagonal one, an invalid slot."""
    hashes = containment_sketches(300) if containment else \
        clustered_sketches(n=300)
    sig = _signatures(hashes, bits, rb, gpu, bound)
    last = sig.n_pad - rb
    tiles = ([0, last, last, 0], [0, 0, last, 0], [1, 1, 1, 0])
    sc = bm.filter_scalars(0.05, 21, bound)
    got = bm.batched_mask(sig.xd, sig.cd, sig.sd, *tiles, *sc, containment,
                          rb, bound)
    want = bm.batched_mask_plain(sig.xd, sig.cd, sig.sd,
                                 *map(np.asarray, tiles), *sc, containment,
                                 rb, bound)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert int(want[0].sum()) > 0


def test_k1_matches_plain_rb8192(gpu):
    """rb = 8192, 8192 bits: an off-diagonal tile, a diagonal tile with
    padded rows and an invalid slot."""
    hashes = clustered_sketches(n=12000, s=1000, n_clusters=64, seed=7)
    sig = _signatures(hashes, 8192, 8192, gpu)
    sc = bm.filter_scalars(0.05, 22)
    tiles = ([8192, 8192, 0], [0, 8192, 0], [1, 1, 0])
    got = bm.batched_mask(sig.xd, sig.cd, sig.sd, *tiles, *sc, False, 8192)
    for t in range(3):
        want = bm.batched_mask_plain(sig.xd, sig.cd, sig.sd,
                                     *(np.asarray(x[t:t + 1]) for x in tiles),
                                     *sc, False, 8192)
        assert torch.equal(got[0][t:t + 1], want[0]), t
        assert torch.equal(got[1][t:t + 1], want[1]), t
        assert t == 2 or int(want[0][0]) > 0


def _resident_masks(gpu, n, rb, n_clusters):
    """K1's masks of every triangular tile, the fourth (where there is one)
    invalid; cluster members sit side by side, so mask bytes hold several
    set bits."""
    hashes = clustered_sketches(n=n, n_clusters=n_clusters)
    hashes = [hashes[i] for i in np.argsort(np.arange(n) % n_clusters,
                                            kind="stable")]
    sig = _signatures(hashes, 1024, rb, gpu)
    tiles = bm.triangle_tiles(sig.n_pad, rb)
    r0s = np.array([r for r, _ in tiles])
    c0s = np.array([c for _, c in tiles])
    val = np.ones(len(tiles), dtype=np.int64)
    val[3:4] = 0
    _, packs = bm.batched_mask(sig.xd, sig.cd, sig.sd, r0s, c0s, val,
                               *bm.filter_scalars(0.05, 21), False, rb)
    geo = torch.from_numpy(np.stack([r0s, c0s, val]).astype(np.int32))
    return packs, geo.to(gpu), sig.n_pad


def _last_word_masks(gpu, rb):
    """The three tiles of 2 rb genomes, all zero but one bit: row 5 of
    tile (rb, 0), in the row's last column word."""
    packs = torch.zeros((3, rb, rb // 8), dtype=torch.uint8, device=gpu)
    packs[1, 5, -1] = 0x80  # column rb - 1
    geo = torch.tensor([[0, rb, rb], [0, 0, rb], [1, 1, 1]],
                       dtype=torch.int32, device=gpu)
    return packs, geo, 2 * rb


# rb: (genomes, planted clusters): every tile at rb = 128 (21 tiles), six
# tiles at rb = 4096, one tile at rb = 8192 (K2's shared memory past 48 KB)
K2_MASKS = {128: (600, 12), 4096: (9000, 64), 8192: (8000, 64)}
K2_CASES = [pytest.param("k1", labels, rb, cap,
                         id=f"rb{rb}-{labels}-cap{cap}")
            for rb in K2_MASKS for labels in ("distinct", "random", "one")
            for cap in (None, 0, 5, "large")] + \
    [pytest.param("last_word", "distinct", rb, cap,
                  id=f"rb{rb}-last_word-cap{cap}")
     for rb in K2_MASKS for cap in (None, 5)]


@pytest.mark.parametrize("masks,labels_mix,rb,cap", K2_CASES)
def test_k2_matches_plain(gpu, masks, labels_mix, rb, cap):
    """K2 (full, or compact with cap 0, 5 or above ncol) against its plain
    versions: outputs and updated masks exactly equal, under all-distinct
    labels (round 1 of the engine), random labels from 40 values and one
    label for all; K1's masks with a clear list of repeated targets, or a
    single set bit in a row's last column word."""
    if masks == "k1":
        packs, geo, n_pad = _resident_masks(gpu, K2_MASKS[rb][0], rb,
                                            K2_MASKS[rb][1])
    else:
        packs, geo, n_pad = _last_word_masks(gpu, rb)
    rng = np.random.default_rng(2)
    labels_np = {"distinct": np.arange(n_pad),
                 "random": rng.integers(0, 40, n_pad),
                 "one": np.zeros(n_pad)}[labels_mix]
    labels = torch.from_numpy(labels_np.astype(np.int32)).to(gpu)
    clr_np = np.zeros((4, 256), dtype=np.int32)
    if masks == "k1":
        clr_np = clear_list(packs.cpu().numpy(), rng)
        assert len({tuple(e) for e in clr_np[:3].T[clr_np[3] > 0]}) < \
            int((clr_np[3] > 0).sum())  # repeated targets
    clr = torch.from_numpy(clr_np).to(gpu)
    mine, ref = packs.clone(), packs.clone()
    before = lp.LAUNCHES["labelprop_round"]
    if cap is None:
        got = lp.lp_round(mine, labels, clr, *geo, rb)
        want = lp.round_plain(ref, labels, clr, *geo, rb)
    else:
        cap = n_pad if cap == "large" else cap
        r_lo, span = 128, min(256, n_pad - 128)
        got = lp.lp_round_compact(mine, labels, clr, *geo, r_lo, rb, span,
                                  cap)
        want = lp.round_compact_plain(ref, labels, clr, *geo, r_lo, rb,
                                      span, cap)
        assert cap != n_pad or int(want[1]) < cap
    torch.cuda.synchronize()
    assert lp.LAUNCHES["labelprop_round"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(mine, ref)
    if masks == "k1":
        assert not torch.equal(mine, packs)  # the clear list took effect
        assert (int(want[0]) == 0) == (labels_mix == "one")
    else:
        assert int(want[0]) == 1
        if cap is None:
            assert int(want[1 + rb + 5]) == rb - 1
            assert int(want[1 + n_pad + rb - 1]) == rb + 5


def _wide_masks(gpu, rb, n_tiles, seed=8):
    """n_tiles random tiles of rb rows whose set bits follow 64 planted
    clusters (bit (i, j) where i and j share i % 64, about one in 64, and
    a few stray bits), over n_tiles * rb genomes: the mesh LP slab's
    pattern."""
    g = torch.Generator(device=gpu).manual_seed(seed)
    rows = torch.arange(rb, device=gpu)
    n_pad = n_tiles * rb
    packs = torch.empty((n_tiles, rb, rb // 8), dtype=torch.uint8,
                        device=gpu)
    for t in range(n_tiles):
        c0 = (t * 3 % n_tiles) * rb
        m = (rows[:, None] % 64) == ((rows[None, :] + c0) % 64)
        m &= torch.rand((rb, rb), generator=g, device=gpu) < 0.9
        m |= torch.rand((rb, rb), generator=g, device=gpu) < 1e-4
        packs[t] = bm.pack_mask_u8(m)
        del m
    geo = torch.tensor([[t * rb for t in range(n_tiles)],
                        [(t * 3 % n_tiles) * rb for t in range(n_tiles)],
                        [1] * n_tiles], dtype=torch.int32, device=gpu)
    return packs, geo, n_pad


@pytest.mark.parametrize("rb,n_tiles", [(16384, 2), (12416, 2), (8320, 3),
                                        (8192, 2)])
def test_k2_wide_rows_match_plain(gpu, rb, n_tiles):
    """K2 over tiles of several spans (rb 16,384: four spans of 4,096
    columns, bands of 1,024 rows; rb 12,416: three full spans and one of
    128 columns, and a last band of 128 rows; rb 8,320: two spans and one
    of 128 columns) and over whole rows of 8,192, against ``round_plain``:
    the fused output and the cleared masks exactly equal, with a clear list
    of repeated targets and random labels."""
    packs, geo, n_pad = _wide_masks(gpu, rb, n_tiles)
    rng = np.random.default_rng(3)
    labels = torch.from_numpy(np.where(
        rng.random(n_pad) < 0.5, np.arange(n_pad) % 64,
        64 + np.arange(n_pad)).astype(np.int32)).to(gpu)
    clr_np = clear_list(packs.cpu().numpy(), rng)
    assert len({tuple(e) for e in clr_np[:3].T[clr_np[3] > 0]}) < \
        int((clr_np[3] > 0).sum())
    clr = torch.from_numpy(clr_np).to(gpu)
    mine, ref = packs.clone(), packs.clone()
    before = lp.LAUNCHES["labelprop_round"]
    got = lp.lp_round(mine, labels, clr, *geo, rb)
    torch.cuda.synchronize()
    assert lp.LAUNCHES["labelprop_round"] == before + 1
    want = lp.round_plain(ref, labels, clr, *geo, rb)
    assert torch.equal(got, want)
    assert torch.equal(mine, ref)
    assert int(want[0]) > 0 and not torch.equal(mine, packs)


@pytest.mark.parametrize("engine_name", ["stream", "lp"])
def test_cluster_engines_on_card_match_host(gpu, engine_name):
    hashes = clustered_sketches(n=1500, s=300, n_clusters=25, seed=4)
    bm.reset_launches()
    lp.reset_launches()
    if engine_name == "lp":  # 21 tiles in panels of 4: compact pulls
        got = lp.threshold_clusters_device_lp(
            hashes, 0.05, 21, row_block=256, panel_tiles=4, device=gpu)
    else:
        got = cluster_fast.threshold_clusters_device(
            hashes, 0.05, 21, row_block=256, engine="stream", device=gpu)
    assert bm.LAUNCHES["filter_mask"] > 0
    assert (lp.LAUNCHES["labelprop_round"] > 0) == (engine_name == "lp")
    want = clusters_from_forest(cut_forest(compute_mst(hashes, 0.05,
                                                       21).mst, 0.05), 1500)
    assert sorted(map(sorted, got)) == sorted(map(sorted, want))


class _Spy:
    """Records the arguments of each call of ``module.name`` and calls
    through (the wrapper's launch count is untouched)."""

    def __init__(self, monkeypatch, module, name):
        real = getattr(module, name)
        self.calls = []

        def wrapper(*args, **kwargs):
            self.calls.append(args)
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)


def _kssd_folder(tmp_path, hashes, name="sketches"):
    from rabbittclust_tpu_torch.sketch.base import SketchSet
    from rabbittclust_tpu_torch.sketch.kssd import KssdParams
    from rabbittclust_tpu_torch.state import sketch_io
    p = KssdParams.from_kmer_size(21, 3)
    ss = SketchSet("kssd", p, True, p.use64)
    for i, h in enumerate(hashes):
        ss.append_genome(file_name=f"g{i}.fna", name=f"g{i}", comment="c",
                         seq0_len=10 ** 6, total_len=10 ** 6, num_seqs=1,
                         hashes=h)
    folder = str(tmp_path / name)
    sketch_io.save_kssd_sketches(ss, p, folder)
    return folder, p


def _cluster_ids(path):
    clusters = []
    with open(path) as f:
        for line in f:
            if line.startswith("the cluster"):
                clusters.append([])
            elif line.startswith("\t"):
                clusters[-1].append(int(line.split("\t")[2]))
    return clusters


@pytest.mark.parametrize("n_clusters", [1500, 25], ids=["sparse", "dense"])
def test_greedy_cli_on_card_matches_native(gpu, tmp_path, monkeypatch,
                                           n_clusters):
    """Phase 8 at N = 3,000: clust-greedy --fast --device --presketched on
    the device sweep (K1 under its greedy bound) = the native greedy."""
    from rabbittclust_tpu_torch.cli.clust_greedy import main
    from rabbittclust_tpu_torch.cluster.greedy import greedy_cluster
    from rabbittclust_tpu_torch.state import sketch_io
    hashes = clustered_sketches(n=3000, s=400, n_clusters=n_clusters, seed=8)
    folder, p = _kssd_folder(tmp_path, hashes)
    monkeypatch.setenv("RTC_GREEDY_DEVICE", "force")
    k1 = _Spy(monkeypatch, bm, "batched_mask")
    bm.reset_launches()
    stats = {}
    out = str(tmp_path / "o.cluster")
    assert main(["--fast", "--device", "--presketched", folder, "-o", out],
                device=gpu, stats=stats) == 0
    assert stats["greedy_route"] == "device"
    assert bm.LAUNCHES["filter_mask"] > 0
    assert {a[12] for a in k1.calls} == {"greedy"}
    ss, _ = sketch_io.load_kssd_sketches(folder)
    ss2 = ss.reorder(ss.kssd_greedy_order())
    ref = greedy_cluster(ss2.hashes, 0.05, p.kmer_size, presorted=True)
    assert _cluster_ids(out) == ref.clusters


@pytest.mark.parametrize("psizes", ["fast", "slow"])
def test_minhash_greedy_on_card_matches_parity(gpu, monkeypatch, psizes):
    """Phase 9a's engine at N = 2,000 (64-bit hashes): K1 under its minhash
    bound with constant sizes on both axes (fast path) or the param sizes
    on the columns (slow path) = the native parity engine."""
    from rabbittclust_tpu_torch.cluster.greedy import minhash_greedy_parity
    from rabbittclust_tpu_torch.ops.greedy_device import minhash_greedy_device
    hashes = clustered_sketches(n=2000, s=400, n_clusters=40, seed=9,
                                dtype=np.uint64, keep=0.8)
    psz = ([400] * len(hashes) if psizes == "fast"
           else [350 + 29 * (i % 5) for i in range(len(hashes))])
    k1 = _Spy(monkeypatch, bm, "batched_mask")
    bm.reset_launches()
    got = minhash_greedy_device(hashes, psz, 0.05, 21, device=gpu)
    assert bm.LAUNCHES["filter_mask"] > 0
    assert {a[12] for a in k1.calls} == {"minhash"}
    want = minhash_greedy_parity(hashes, psz, 0.05, 21, False)
    assert got.clusters == want.clusters
    assert got.representatives == want.representatives


def test_minhash_dense_engine_on_card_two_planes(gpu, monkeypatch):
    """Phase 9b's engine at N = 3,000 of 64-bit hashes: K4's mask mode and
    K5b on two planes, the MST held to the host engine."""
    hashes = clustered_sketches(n=3000, s=400, n_clusters=30, seed=6,
                                dtype=np.uint64)
    k4 = _Spy(monkeypatch, engine, "pair_mask_tiles")
    k5b = _Spy(monkeypatch, engine, "pair_common")
    ix.reset_launches()
    got = engine.compute_mst_device(hashes, 0.05, 21, device=gpu)
    assert ix.LAUNCHES["pair_mask_tiles"] > 0 and ix.LAUNCHES["pair_common"] > 0
    assert all(a[1] is not None for a in k4.calls + k5b.calls)
    want = compute_mst(hashes, 0.05, 21)
    assert len(got.mst[0]) == len(want.mst[0])
    np.testing.assert_allclose(np.sort(got.mst[2]), np.sort(want.mst[2]),
                               rtol=1e-12, atol=0)


def test_append_engine_on_card_matches_host(gpu, monkeypatch):
    """Phase 10's engine: start_index = 2,500 of 3,000 and the saved MST as
    pre_edges; K4's mask mode launched with that start_index."""
    hashes = clustered_sketches(n=3000, s=400, n_clusters=30, seed=2)
    pre = compute_mst(hashes[:2500], 0.05, 21).mst
    k4 = _Spy(monkeypatch, engine, "pair_mask_tiles")
    got = engine.compute_mst_device(hashes, 0.05, 21, start_index=2500,
                                    pre_edges=pre, device=gpu)
    assert k4.calls and {a[7] for a in k4.calls} == {2500}
    want = compute_mst(hashes, 0.05, 21, start_index=2500, pre_edges=pre)
    assert len(got.mst[0]) == len(want.mst[0])
    np.testing.assert_allclose(np.sort(got.mst[2]), np.sort(want.mst[2]),
                               rtol=1e-12, atol=0)
    n = len(hashes)
    part = sorted(map(sorted, clusters_from_forest(cut_forest(got.mst, 0.05),
                                                   n)))
    ref = sorted(map(sorted, clusters_from_forest(cut_forest(want.mst, 0.05),
                                                  n)))
    assert part == ref


def _k3_case(hashes, rb, tiles, gpu, bits=2048):
    """K1's counts and packs of ``tiles`` and the plain K3's indices of
    the tiles with a candidate."""
    sig = _signatures(hashes, bits, rb, gpu)
    sc = bm.filter_scalars(0.05, 21)
    counts, packs = bm.batched_mask(sig.xd, sig.cd, sig.sd, *tiles, *sc,
                                    False, rb)
    cnt = counts.cpu().numpy()
    sel = [t for t in range(len(cnt)) if cnt[t]]
    return sig, sc, cnt, packs, sel


@pytest.mark.parametrize("rb,n", [(128, 300), (256, 300), (1024, 1500)])
def test_k3_matches_plain(gpu, rb, n):
    """K3 over K1's masks, ragged n (padded last row block) and a padding
    tile, against the plain compaction; every tile, then only the nonzero
    ones in a permuted order.  One launch a call, and one more when the
    total outgrows the capacity seen so far (``RELAUNCHES``)."""
    hashes = clustered_sketches(n=n, s=150, n_clusters=10)
    n_pad = -(-n // rb) * rb
    tiles = bm.triangle_tiles(n_pad, rb)[:15]
    geo = [[r for r, _ in tiles] + [0], [c for _, c in tiles] + [0],
           [1] * len(tiles) + [0]]
    _, _, cnt, packs, sel = _k3_case(hashes, rb, geo, gpu)
    for order in (list(range(len(cnt))), sel[::-1]):
        before = bm.LAUNCHES["mask_compact"]
        again = bm.RELAUNCHES["mask_compact"]
        got = bm.compact_masks(packs, cnt, order)
        torch.cuda.synchronize()
        again = bm.RELAUNCHES["mask_compact"] - again
        assert again <= 1
        assert bm.LAUNCHES["mask_compact"] == before + 1 + again
        want = bm.compact_masks_plain(packs, order)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(cnt.sum()) > 0 and cnt[-1] == 0


def test_k3_edge_cases(gpu):
    """An empty selection (nothing to launch), tiles counted 0 (one
    launch: the counts stay on the card, and it finds them 0), a single
    set bit in the last column of the last row of the last tile, and an
    all-zero tile among full ones."""
    rb = 256
    packs = torch.zeros((4, rb, rb // 8), dtype=torch.uint8, device=gpu)
    before = bm.LAUNCHES["mask_compact"]
    assert bm.compact_masks(packs, np.zeros(4), []).numel() == 0
    assert bm.LAUNCHES["mask_compact"] == before  # nothing to launch
    assert bm.compact_masks(packs, np.zeros(4), [0, 1]).numel() == 0
    assert bm.LAUNCHES["mask_compact"] == before + 1
    packs[3, rb - 1, rb // 8 - 1] = 0x80
    got = bm.compact_masks(packs, np.array([0, 0, 0, 1]), [3])
    assert got.tolist() == [rb * rb - 1]
    got = bm.compact_masks(packs, np.array([0, 0, 0, 1]), [0, 1, 2, 3])
    assert got.tolist() == [4 * rb * rb - 1]
    packs[1] = 0xFF
    packs[2] = 0xA5
    cnt = [int(bm.unpack_bits(t.reshape(-1, rb // 8), torch.uint8).sum())
           for t in packs]
    got = bm.compact_masks(packs, cnt, [0, 1, 2, 3])
    assert torch.equal(got, bm.compact_masks_plain(packs, [0, 1, 2, 3]))
    assert got.numel() == sum(cnt) == rb * rb + rb * rb // 2 + 1


def test_k3_rejects_int32_wrap_before_launch(gpu):
    packs = torch.zeros((1, 16384, 2048), dtype=torch.uint8,
                        device=gpu).expand(8, -1, -1)
    before = bm.LAUNCHES["mask_compact"]
    with pytest.raises(ValueError, match="int32"):
        bm.compact_masks(packs, np.ones(8, dtype=np.int64), [0])
    assert bm.LAUNCHES["mask_compact"] == before


def _hold_k3(packs, counts, limit, cap=None, **kw):
    """``compact_masks_into`` on the card against its plain version on the
    same tensors: the whole output buffer (a -7 sentinel past what is
    written) and the head [total, largest count] equal.  Returns the
    head."""
    cap = limit + 64 if cap is None else cap
    outs, heads = [], []
    for fn in (bm.compact_masks_into, bm.compact_masks_into_plain):
        out = torch.full((cap,), -7, dtype=torch.int32, device=packs.device)
        head = torch.full((2,), -7, dtype=torch.int32, device=packs.device)
        fn(packs, counts, out, limit, head=head, **kw)
        outs.append(out)
        heads.append(head)
    torch.cuda.synchronize()
    assert torch.equal(heads[0], heads[1]), (heads[0], heads[1])
    assert torch.equal(outs[0], outs[1])
    return heads[0]


def _popcounts(packs):
    """Each tile's set bits, int32 on the packs' device."""
    table = torch.tensor([bin(v).count("1") for v in range(256)],
                         dtype=torch.int32, device=packs.device)
    return table[packs.reshape(packs.shape[0], -1).long()].sum(
        1, dtype=torch.int32)


def _random_packs(gpu, k, rb, density, seed):
    """k random (rb, rb) masks of the given density, packed on the card,
    the second tile left empty."""
    gen = torch.Generator(device=gpu).manual_seed(seed)
    bits = torch.rand((k, rb, rb), generator=gen, device=gpu) < density
    if k > 1:
        bits[1] = False
    return bm.pack_mask_u8(bits)


def test_k3_single_pass_all_zero_batch(gpu):
    """16 tiles with no set bit: one launch, total and largest count 0,
    nothing written; tiles whose masks hold bits but are counted 0 are
    not read."""
    packs = torch.zeros((16, 1024, 128), dtype=torch.uint8, device=gpu)
    zero = torch.zeros(16, dtype=torch.int32, device=gpu)
    before = bm.LAUNCHES["mask_compact"]
    assert _hold_k3(packs, zero, 100).tolist() == [0, 0]
    assert bm.LAUNCHES["mask_compact"] == before + 1
    packs.fill_(0xA5)
    assert _hold_k3(packs, zero, 100).tolist() == [0, 0]


def test_k3_single_pass_all_ones_tile(gpu):
    """One all-ones 4096^2 tile: 16,777,216 indices in order."""
    rb = 4096
    packs = torch.full((1, rb, rb // 8), 0xFF, dtype=torch.uint8, device=gpu)
    counts = torch.tensor([rb * rb], dtype=torch.int32, device=gpu)
    head = _hold_k3(packs, counts, rb * rb)
    assert head.tolist() == [rb * rb, rb * rb]


@pytest.mark.parametrize("density", [1e-6, 1e-3, 0.05, 0.5])
@pytest.mark.parametrize("rb,k", [(128, 16), (1024, 16), (4096, 4)])
def test_k3_single_pass_random_densities(gpu, rb, k, density):
    """Random masks from 1e-6 to 0.5 at rb 128 to 4096, an empty tile
    among them, encoded by slot, locally and by host codes, and with a
    limit short of the total."""
    packs = _random_packs(gpu, k, rb, density, seed=rb + k)
    counts = _popcounts(packs)
    total = int(counts.sum())
    for kw in ({}, {"codes": "local"},
               {"codes": list(range(k, 0, -1)), "sel": list(range(k))}):
        head = _hold_k3(packs, counts, total, **kw)
        assert int(head[0]) == total
    _hold_k3(packs, counts, total // 2, cap=total + 64)


def test_k3_single_pass_slab_of_16384(gpu):
    """A slab of 5 steps of 16384^2 (the bitmap ring's close at N =
    131,072): the look-back spans 2,048 blocks a step, more than one wave;
    one step empty, one dense."""
    rb = 16384
    packs = torch.zeros((5, rb, rb // 8), dtype=torch.uint8, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(5)
    for t, density in ((0, 1e-4), (2, 0.02), (3, 0.5), (4, 1e-6)):
        packs[t] = bm.pack_mask_u8(
            torch.rand((rb, rb), generator=gen, device=gpu) < density)
    counts = _popcounts(packs)
    assert int(counts[1]) == 0
    total = int(counts.sum())
    assert int(_hold_k3(packs, counts, total, codes="local")[0]) == total
    got = bm.compact_steps(packs, counts)
    assert torch.equal(got, torch.cat([bm.compact_masks_plain(packs, [t])
                                       for t in (0, 2, 3, 4)]))


def test_k3_fifty_calls_without_reset(gpu):
    """50 launches in a row on one scratch, shapes and grids changing from
    call to call, nothing cleared between them: each equal to its plain
    version; the ticket word back at 0 and the epoch 50 further on."""
    cases = []
    for i, (rb, k, d) in enumerate(((128, 16, 0.3), (1024, 16, 1e-3),
                                    (4096, 2, 0.05), (256, 3, 0.5))):
        packs = _random_packs(gpu, k, rb, d, seed=i)
        counts = _popcounts(packs)
        out = torch.full((int(counts.sum()) + 8,), -7, dtype=torch.int32,
                         device=gpu)
        bm.compact_masks_into_plain(packs, counts, out, out.numel() - 8)
        cases.append((packs, counts, out))
    torch.cuda.synchronize()
    scratch = bm.k3_scratch(gpu, 1 << 14)
    epoch = scratch.epoch
    for i in range(50):
        packs, counts, want = cases[i % len(cases)]
        got = torch.full_like(want, -7)
        bm.compact_masks_into(packs, counts, got, got.numel() - 8)
        assert torch.equal(got, want), i
    assert bm.k3_scratch(gpu, 1) is scratch
    assert int(scratch.words[0]) == 0
    assert scratch.epoch == epoch + 50


@pytest.mark.parametrize("b,r,tri", [(2048, 1024, False),
                                     (2048, 16384, False),
                                     (2048, 2048, True), (7, 1024, False)],
                         ids=["R1024", "R16384", "tri", "B7"])
def test_k3_row_form_at_k6_shapes(gpu, b, r, tri):
    """K3's row form inside K6 at the batched greedy's shapes (B = 2,048
    against 1,024 and 16,384 reps, triangular, B = 7), a cap that the
    dense case runs past: the whole buffer equal to the plain version."""
    from rabbittclust_tpu_torch.ops import greedy_device as gd
    x, coll, sizes, n_pad = _k6_inputs(gpu, n=2500, s_n=60)
    rng = np.random.default_rng(b + r)
    bi = rng.integers(0, n_pad, b)
    ri = bi[:r] if tri else rng.integers(0, n_pad, r)
    sc = bm.filter_scalars(0.05, 21, "greedy")
    for cap in (1 << 18, 1000):
        args = (x, bi, ri, coll, sizes, *sc, False, cap, tri)
        got = gd.greedy_filter(*args)
        want = gd.greedy_filter_plain(
            x, torch.from_numpy(bi).to(gpu, torch.int32),
            torch.from_numpy(ri).to(gpu, torch.int32), coll, sizes, *sc,
            False, cap, tri)
        assert torch.equal(got, want), (cap, int(got[0]), int(want[0]))
        assert int(want[0]) > 0


def test_idx_generator_syncs_not_between_k1_and_k3(gpu, monkeypatch):
    """Under RTC_PULL_MODE=idx the generator queues K3 straight behind
    each K1: no host synchronisation from K1's launch until K3's is
    queued (``torch.cuda.set_sync_debug_mode("error")`` raises on one),
    K3 once a batch, and the pairs those of the mask pull."""
    hashes = clustered_sketches(n=3000, s=400, n_clusters=30, seed=4)
    monkeypatch.setattr(bm, "K3_START_CAPACITY", 1 << 22)  # no regrowth
    monkeypatch.setattr(bm, "_K3_CAPACITY", {})
    k1, k3 = bm.batched_mask, bm.compact_masks_into
    windows = []

    def after_k1(*args, **kwargs):
        out = k1(*args, **kwargs)
        torch.cuda.set_sync_debug_mode("error")
        windows.append("open")
        return out

    def k3_closes(*args, **kwargs):
        try:
            return k3(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            windows.append("closed")

    seqs = {}
    for mode in ("mask", "idx"):
        monkeypatch.setenv("RTC_PULL_MODE", mode)
        if mode == "idx":
            monkeypatch.setattr(bm, "batched_mask", after_k1)
            monkeypatch.setattr(bm, "compact_masks_into", k3_closes)
        bm.reset_launches()
        try:
            blocks = list(bm.candidate_pair_blocks(hashes, 0.05, 21,
                                                   row_block=1024,
                                                   device=gpu))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seqs[mode] = (np.concatenate([b[0] for b in blocks]),
                      np.concatenate([b[1] for b in blocks]))
    n_batches = bm.LAUNCHES["filter_mask"]
    assert windows == ["open", "closed"] * n_batches
    assert bm.LAUNCHES["mask_compact"] == n_batches
    assert all(np.array_equal(a, b) for a, b in zip(seqs["mask"],
                                                    seqs["idx"]))


@pytest.mark.parametrize("rb,n_clusters", [(256, 10), (1024, 750)],
                         ids=["flat", "two_level"])
def test_batched_filter_matches_plain(gpu, rb, n_clusters):
    """K1 + K3 (``batched_filter``) against the plain program, whole
    buffer: head, indices and the -1 / encoded-padding tail.  Dense tiles
    at rb 256 take the flat branch (cap_chunks over the chunk grid); pairs
    of genomes (750 clusters of 2) at rb 1024 the two-level one, both
    sized from the exact counts as the JAX generator sizes them."""
    hashes = clustered_sketches(n=1500, s=150, n_clusters=n_clusters)
    n_pad = -(-1500 // rb) * rb
    tiles = bm.triangle_tiles(n_pad, rb)[:5]
    for valid in ([1] * len(tiles), [1] * (len(tiles) - 1) + [0]):
        geo = ([r for r, _ in tiles], [c for _, c in tiles], valid)
        sig, sc, cnt, _, _ = _k3_case(hashes, rb, geo, gpu)
        cap = int(cnt.max())
        grid = rb * (rb // min(512, rb))
        cap_chunks = cap if n_clusters > 10 else 1 << 20
        assert (cap_chunks < grid) == (n_clusters > 10)
        args = (sig.xd, sig.cd, sig.sd, np.arange(len(tiles)),
                *map(np.asarray, geo), *sc, False, cap, cap_chunks, rb)
        got = bm.batched_filter(*args)
        want = bm.batched_filter_plain(*args)
        assert torch.equal(got, want), valid
        assert int(want[0]) > 0


def test_stream_generator_idx_on_card(gpu, monkeypatch):
    """candidate_pair_blocks under idx on the card: K3 launched, the same
    pairs in the same order as under mask."""
    hashes = clustered_sketches(n=3000, s=400, n_clusters=30, seed=4)
    seqs = {}
    for mode in ("mask", "idx"):
        monkeypatch.setenv("RTC_PULL_MODE", mode)
        bm.reset_launches()
        blocks = list(bm.candidate_pair_blocks(hashes, 0.05, 21,
                                               row_block=1024, device=gpu))
        seqs[mode] = (np.concatenate([b[0] for b in blocks]),
                      np.concatenate([b[1] for b in blocks]))
        assert (bm.LAUNCHES["mask_compact"] > 0) == (mode == "idx")
    assert all(np.array_equal(a, b) for a, b in zip(seqs["mask"],
                                                    seqs["idx"]))


# ---------------------------------------------------------------------------
# K7 (the device KSSD sketcher) and K8 (WMH / OMH token matches)


def _k7_inputs(gpu, k, dr, window, table_kind="shuffle"):
    from rabbittclust_tpu_torch.sketch.kssd import KssdParams, \
        get_shuffle_table
    p = KssdParams.from_kmer_size(k, dr)
    table = get_shuffle_table(p.half_subk) if table_kind == "shuffle" \
        else dense_keep_table(p.dim_end, p.half_subk, k)
    return p, torch.from_numpy(window).to(gpu), torch.from_numpy(table).to(gpu)


def _k7_hold(codes, table, p):
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    before = sd.LAUNCHES["kssd_sketch"]
    h, pos = sd.sketch_window(codes, table, p)
    torch.cuda.synchronize()
    assert sd.LAUNCHES["kssd_sketch"] == before + 1
    wh, wpos = sd.sketch_window_plain(codes, table, p)
    assert torch.equal(h, wh) and torch.equal(pos, wpos)
    return int(h.numel())


@pytest.mark.parametrize("table_kind", ["shuffle", "dense"])
@pytest.mark.parametrize("k,dr", [(21, 3), (23, 3), (31, 2), (32, 3)])
def test_k7_matches_plain(gpu, k, dr, table_kind):
    """One window of 2^20 positions with invalid codes, record separators,
    a low-complexity run and a padded tail (the dense table keeps nearly
    every window): the ordered (hash, position) rows equal."""
    kk = 2 * ((k + 1) // 2)
    p, codes, table = _k7_inputs(gpu, k, dr,
                                 kssd_window(k + dr, kk, 1 << 20),
                                 table_kind)
    total = _k7_hold(codes, table, p)
    assert total > (300_000 if table_kind == "dense" else 0)


def test_k7_edges(gpu):
    """Ragged windows (1 position, 10,001, one past a span, ending inside a
    span), separators at a span's edge, an all-invalid window, a full
    64-bit tuple width, a table that keeps nothing, and k = 2."""
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    from rabbittclust_tpu_torch.sketch.kssd import KssdParams
    rng = np.random.default_rng(5)
    for k, dr, n_pos in ((21, 3, 1), (16, 2, 10_001), (31, 2, 8193),
                         (23, 3, 3 * 8192)):
        kk = 2 * ((k + 1) // 2)
        w = rng.integers(0, 4, n_pos + kk - 1).astype(np.int8)
        for at in (8192 - kk, 8192, 16384 - 1):
            w[at:at + kk - 1] = -1
        for kind in ("shuffle", "dense"):
            p, codes, table = _k7_inputs(gpu, k, dr, w, kind)
            _k7_hold(codes, table, p)
    p, codes, table = _k7_inputs(gpu, 21, 3,
                                 np.full(20_000, -1, dtype=np.int8))
    assert _k7_hold(codes, table, p) == 0
    # windows ending inside a span of K7_SPAN positions
    for n_pos in (5000, 2 * 8192 + 4097):
        p, codes, table = _k7_inputs(gpu, 23, 3,
                                     kssd_window(n_pos, 24, n_pos), "dense")
        assert _k7_hold(codes, table, p) > 0
    # a table whose ranks all lie past dim_end: nothing kept; its bitmap
    # has no bit set
    p, codes, _ = _k7_inputs(gpu, 21, 3, kssd_window(3, 22, 30_000))
    none = torch.full((1 << (4 * p.half_subk),), p.dim_end,
                      dtype=torch.int32, device=gpu)
    assert _k7_hold(codes, none, p) == 0
    assert int(sd.keep_bitmap(none, p.dim_end).count_nonzero()) == 0
    # k = 2 (one base of context a side: 16 dimensions, half_subk 1)
    p = KssdParams(half_k=1, half_subk=1, drlevel=0)
    t16 = rng.integers(-4, 24, 16).astype(np.int32)
    codes = torch.from_numpy(kssd_window(9, 2, 40_000)).to(gpu)
    assert _k7_hold(codes, torch.from_numpy(t16).to(gpu), p) > 0


def test_k7_keep_bitmap_matches_plain(gpu):
    """K7's keep bitmap kernel against its plain version: the shuffle and a
    dense table at half_subk 6 (fine words and the coarse level), a table
    of 16 dimensions, and a table modified in place (built again)."""
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    from rabbittclust_tpu_torch.sketch.kssd import get_shuffle_table
    cases = [(get_shuffle_table(6), 1 << 12),
             (dense_keep_table(1 << 12, 6, 21), 1 << 12),
             (np.arange(16, dtype=np.int32)[::-1].copy(), 5)]
    for table_np, dim_end in cases:
        table = torch.from_numpy(table_np).to(gpu)
        before = sd.LAUNCHES["kssd_keep_bitmap"]
        got = sd.keep_bitmap(table, dim_end)
        assert sd.keep_bitmap(table, dim_end) is got  # kept on the table
        assert sd.LAUNCHES["kssd_keep_bitmap"] == before + 1
        assert torch.equal(got, sd.keep_bitmap_plain(table, dim_end))
    table[3] = 0  # in place: the bitmap is built again
    assert torch.equal(sd.keep_bitmap(table, 5),
                       sd.keep_bitmap_plain(table, 5))
    assert sd.LAUNCHES["kssd_keep_bitmap"] == before + 2


def test_k7_rejects_bad_inputs(gpu):
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    p, codes, table = _k7_inputs(gpu, 21, 3, kssd_window(1, 22, 9000))
    with pytest.raises(ValueError, match="aligned"):
        sd.sketch_window(codes[1:], table, p)
    with pytest.raises(ValueError, match="table"):
        sd.sketch_window(codes, table[:-1], p)


def _write_genomes(tmp_path, n_groups, per, length, seed, records=1):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    files = []
    for g in range(n_groups):
        base = rng.integers(0, 4, length)
        for m in range(per):
            seq = base.copy()
            hit = rng.random(length) < 0.01
            seq[hit] = rng.integers(0, 4, int(hit.sum()))
            files.append(str(tmp_path / f"g{g}_{m}.fna"))
            cut = np.linspace(0, length, records + 1).astype(int)
            with open(files[-1], "wb") as f:
                for r in range(records):
                    f.write(f">g{g}_{m}_{r} group{g}\n".encode())
                    f.write(acgt[seq[cut[r]:cut[r + 1]]].tobytes() + b"\n")
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(files) + "\n")
    return files, str(lst)


@pytest.mark.parametrize("k,dr", [(21, 3), (23, 3)])
def test_k7_stream_equals_native_sketcher(gpu, tmp_path, k, dr):
    """Files spanning several windows (4 rows of 8,192 positions), two
    records each: the card's sketches equal the native sketcher's."""
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    from rabbittclust_tpu_torch.sketch.kssd import sketch_files_kssd
    files, _ = _write_genomes(tmp_path, 3, 2, 50_000, 8, records=2)
    ss_h, _ = sketch_files_kssd(files, 1000, k, dr)
    sd.reset_launches()
    ss_d, _ = sd.sketch_files_kssd_device(files, 1000, k, dr, chunk=8192,
                                          s_rows=4, device=gpu)
    # six genomes of two records: 11 separators of k - 1 codes
    kk = 2 * ((k + 1) // 2)
    assert sd.LAUNCHES["kssd_sketch"] == -(-(300_000 + 11 * (kk - 1))
                                           // 32768)
    for gh, gd in zip(ss_h.hashes, ss_d.hashes):
        assert gh.dtype == gd.dtype and np.array_equal(gh, gd)
    assert ss_h.names == ss_d.names and ss_h.total_lens == ss_d.total_lens


def _adversarial_tokens(kind, n, s, c, seed=5):
    """Every row equal, every row distinct, or rows in groups of 5 that
    differ from their group's base only in the last or the first word."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 2 ** 32, (n, s, c), dtype=np.uint64).astype(
        np.uint32)
    if kind == "equal":
        return np.ascontiguousarray(np.broadcast_to(tok[:1], tok.shape))
    if kind == "distinct":
        return tok
    base = tok[::5].repeat(5, axis=0)[:n]
    word = c - 1 if kind == "last" else 0
    base[:, :, word] ^= (rng.random((n, s)) < 0.5).astype(np.uint32) * \
        np.uint32(1 + 0x10001 * (np.arange(n) % 5))[:, None]
    return base


K8_TOKENS = [pytest.param("planted", n, s, c, id=f"n{n}-s{s}c{c}")
             for n in (1, 63, 64, 65, 700, 4100)
             for s, c in ((50, 4), (64, 6), (7, 1), (3, 8))] + \
    [pytest.param(kind, 700, s, c, id=f"{kind}-s{s}c{c}")
     for kind in ("equal", "distinct", "last", "first")
     for s, c in ((50, 4), (7, 1), (3, 8))]


@pytest.mark.parametrize("form", ["packed", "int32"])
@pytest.mark.parametrize("kind,n,s,c", K8_TOKENS)
def test_k8_matches_plain(gpu, monkeypatch, kind, n, s, c, form):
    """K8 (the id pass, then the pairs over the lower triangle's tiles with
    their transposes) against its plain version, in the packed form (two
    samples' ids a word as fp16 patterns) and the int32 form (the packed
    form's limit set to 0): one counted launch a call."""
    from rabbittclust_tpu_torch.ops import extra_pairs as xp
    if form == "int32":
        monkeypatch.setattr(xp, "PACK_MAX_N", 0)
    tok_np = planted_tokens(n, s, c, seed=n + s) if kind == "planted" \
        else _adversarial_tokens(kind, n, s, c)
    tok = torch.from_numpy(tok_np.view(np.int32)).to(gpu)
    before = dict(xp.LAUNCHES)
    got = xp.tuple_matches(tok)
    torch.cuda.synchronize()
    assert xp.LAUNCHES["tuple_match"] == before["tuple_match"] + 1
    assert xp.LAUNCHES["tuple_ids"] == before["tuple_ids"] + 1
    assert torch.equal(got, xp.tuple_matches_plain(tok))


@pytest.mark.parametrize("kind,n,s,c", [
    ("planted", 1, 3, 8), ("planted", 65, 7, 1), ("planted", 4100, 50, 4),
    ("planted", 700, 64, 6), ("equal", 700, 50, 4),
    ("distinct", 700, 7, 1), ("last", 700, 50, 4), ("first", 700, 3, 8),
    ("planted", 20000, 2, 2)])
def test_k8_ids_match_plain(gpu, kind, n, s, c):
    """K8's id pass alone (``tuple_ids``: each sample's hash table, then
    each row's class's smallest row) element for element against
    ``tuple_ids_plain``, one counted launch; N = 20,000 takes tables of
    65,536 slots."""
    from rabbittclust_tpu_torch.ops import extra_pairs as xp
    tok_np = planted_tokens(n, s, c, seed=n + s) if kind == "planted" \
        else _adversarial_tokens(kind, n, s, c)
    tok = torch.from_numpy(tok_np.view(np.int32)).to(gpu)
    before = xp.LAUNCHES["tuple_ids"]
    got = xp.tuple_ids(tok)
    torch.cuda.synchronize()
    assert xp.LAUNCHES["tuple_ids"] == before + 1
    assert torch.equal(got, xp.tuple_ids_plain(tok))


def test_k8_rejects_nine_words(gpu):
    from rabbittclust_tpu_torch.ops import extra_pairs as xp
    tok = torch.zeros((4, 2, 9), dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="words"):
        xp.tuple_matches(tok)


@pytest.mark.parametrize("func", ["WMH", "OMH", "HLL"])
def test_extra_sketch_cli_on_card(gpu, tmp_path, monkeypatch, func):
    """``--sketch-func``: the card's .cluster equals the CPU run's, and K8
    is launched for WMH and OMH (without --device), not for HLL."""
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.ops import extra_pairs as xp
    _, lst = _write_genomes(tmp_path, 4, 3, 12_000, 9)
    monkeypatch.chdir(tmp_path)
    thr = {"WMH": "0.5", "HLL": "0.05", "OMH": "0.2"}[func]
    argv = ["--sketch-func", func, "-l", "-i", lst, "-d", thr, "-m", "1000"]
    xp.reset_launches()
    assert main(argv + ["-o", "card.cluster"]) == 0
    assert (xp.LAUNCHES["tuple_match"] == 1) == (func != "HLL")
    assert main(argv + ["-o", "cpu.cluster"],
                device=torch.device("cpu")) == 0
    assert (tmp_path / "card.cluster").read_bytes() == \
        (tmp_path / "cpu.cluster").read_bytes()
    assert len(_cluster_ids(str(tmp_path / "card.cluster"))) == 4


def test_device_sketch_cli_on_card(gpu, tmp_path, monkeypatch):
    """``RTC_DEVICE_SKETCH=1`` clust-mst --fast --device: K7 launched, the
    .cluster and the saved folder byte-equal to the native sketcher's."""
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.ops import sketch_device as sd
    _, lst = _write_genomes(tmp_path, 4, 3, 60_000, 10, records=2)
    folders = {}
    for mode in ("1", "0"):
        wd = tmp_path / f"run{mode}"
        wd.mkdir()
        monkeypatch.chdir(wd)
        monkeypatch.setenv("RTC_DEVICE_SKETCH", mode)
        sd.reset_launches()
        assert main(["--fast", "--device", "-l", "-i", lst, "-d", "0.05",
                     "-m", "1000", "-o", "out.cluster"]) == 0
        assert (sd.LAUNCHES["kssd_sketch"] > 0) == (mode == "1")
        (run,) = [p for p in wd.iterdir() if p.is_dir()]
        folders[mode] = {p.name: p.read_bytes() for p in run.iterdir()}
        folders[mode]["out.cluster"] = (wd / "out.cluster").read_bytes()
    assert folders["1"] == folders["0"]


# ---------------------------------------------------------------------------
# K6 (greedy_filter) and the batched greedy route

def _k6_inputs(gpu, n=300, bits=1024, containment=False, seed=4, s_n=12):
    from rabbittclust_tpu_torch.ops.greedy_device import pack_bitmaps_packed
    hashes = (containment_sketches(n=n, seed=seed) if containment else
              clustered_sketches(n=n, s=150, n_clusters=s_n, seed=seed))
    xp, coll = pack_bitmaps_packed(hashes, bits=bits, pad_n_to=128)
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    return (torch.from_numpy(xp).to(gpu), torch.from_numpy(coll).to(gpu),
            torch.from_numpy(sizes).to(gpu), xp.shape[0])


@pytest.mark.parametrize("containment", [False, True], ids=["mash", "aaf"])
@pytest.mark.parametrize("triangular", [False, True], ids=["rect", "tri"])
@pytest.mark.parametrize("b,r,cap", [(7, 1024, 4096), (64, 5, 512),
                                     (200, 300, 100000), (200, 300, 50)],
                         ids=["b7", "r5", "ragged", "overflow"])
def test_k6_matches_plain(gpu, containment, triangular, b, r, cap):
    """The whole fused buffer [count, flat (cap)], the -1 tail and a
    count above cap included, on ragged batch and rep counts; pad slots
    (the last padded row, size 0) among the indices."""
    from rabbittclust_tpu_torch.ops import greedy_device as gd
    x, coll, sizes, n_pad = _k6_inputs(gpu, containment=containment)
    rng = np.random.default_rng(b + r)
    bi = rng.integers(0, n_pad, b)
    ri = rng.integers(0, n_pad, r)
    bi[-1] = ri[-1] = n_pad - 1
    if triangular:
        ri = bi[:min(b, r)]
    sc = bm.filter_scalars(0.05, 21, "greedy")
    args = (x, bi, ri, coll, sizes, *sc, containment, cap, triangular)
    before = gd.LAUNCHES["greedy_filter"]
    got = gd.greedy_filter(*args)
    assert gd.LAUNCHES["greedy_filter"] == before + 1
    want = gd.greedy_filter_plain(
        x, torch.from_numpy(bi).to(gpu, torch.int32),
        torch.from_numpy(ri).to(gpu, torch.int32), coll, sizes, *sc,
        containment, cap, triangular)
    assert torch.equal(got, want), (int(got[0]), int(want[0]))


@pytest.mark.parametrize("bs", [7, 64])
@pytest.mark.parametrize("containment", [False, True], ids=["mash", "aaf"])
def test_batched_greedy_on_card_matches_host(gpu, bs, containment):
    from rabbittclust_tpu_torch.cluster.greedy import greedy_cluster_batched
    from rabbittclust_tpu_torch.ops import greedy_device as gd
    hashes = clustered_sketches(n=400, s=200, n_clusters=30, seed=8)
    host = greedy_cluster_batched(hashes, 0.05, 21, batch_size=bs,
                                  is_containment=containment)
    gd.reset_launches()
    dev = gd.greedy_cluster_device(hashes, 0.05, 21, batch_size=bs,
                                   is_containment=containment,
                                   conflict="batched", device=gpu)
    assert gd.LAUNCHES["greedy_filter"] == -(-(len(hashes) - 1) // bs)
    assert host.representatives == dev.representatives
    assert host.clusters == dev.clusters


# ---------------------------------------------------------------------------
# The mesh rings over repeated card devices

def _ring_corpus(n=300, use64=False):
    return clustered_sketches(n=n, s=160, n_clusters=11, seed=21,
                              dtype=np.uint64 if use64 else np.uint32,
                              keep=0.8)


def _ring_shards(kind, hashes, mesh, bits=1024):
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    n = len(hashes)
    if kind == "edges":
        p0, p1, sz = de._pack_rows_for_mesh(hashes, mesh)
        return de._plane_shards(p0, p1, sz, mesh, p0.shape[0])
    pad = mesh.size * 128 if kind == "masks" else mesh.size
    xp, coll = bm.pack_bitmaps_packed(hashes, bits=bits, pad_n_to=pad)
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    return de._bit_shards(xp, coll, sizes, mesh)


def _ragged_shards(hashes, n_dev, rows, bits, dev):
    """Bit shards of ``rows`` rows each (a multiple of 32, not of 128),
    built by hand: ``_bit_shards`` pads them to 128 on the card."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    hashes = hashes[:n_dev * rows - 5]
    xp, coll = bm.pack_bitmaps_packed(hashes, bits=bits,
                                      pad_n_to=n_dev * rows)
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:len(hashes)] = [len(h) for h in hashes]
    return [de.BitShard(*(torch.from_numpy(a[d * rows:(d + 1) * rows])
                          .to(dev) for a in (xp, coll, sizes)), d * rows)
            for d in range(n_dev)]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kind,use64,bits,rows", [
    ("edges", False, 0, 0), ("edges", True, 0, 0), ("bitmap", False, 1024, 0),
    ("masks", False, 1024, 0), ("masks", True, 64, 0), ("masks", False, 256, 0),
    ("masks", False, 8192, 0), ("masks", False, 64, 96),
    ("masks", True, 256, 160), ("masks", False, 1024, 96),
    ("masks", False, 8192, 160)],
    ids=["edges-32bit", "edges-64bit", "bitmap", "masks", "masks-64bits",
         "masks-256bits", "masks-8192bits", "masks-rows96-64bits",
         "masks-rows160-256bits", "masks-rows96-1024bits",
         "masks-rows160-8192bits"])
def test_ring_steps_match_plain(gpu, n_dev, kind, use64, bits, rows):
    """Every (device, step) of each ring over [cuda:0] * n_dev: the
    kernels (tile kinds self / full / none) against the plain step (the
    JAX ownership mask on genome ids); shards padded to 128 rows, or of
    ``rows`` rows (ragged: a multiple of 32) built by hand; signatures of
    ``bits`` bits (64: no TMA; 256: a short TMA box).  The bitmap ring
    runs whole in its slab form: each shard's slab and counts against the
    plain steps' masks, then its closing compaction against the plain
    steps' positions, step after step.  The bitmap rings hash 64-bit
    sketches into one plane like 32-bit ones."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    mesh = de.make_mesh(devices=[gpu] * n_dev)
    hashes = _ring_corpus(n=max(300, n_dev * rows), use64=use64)
    shards = (_ragged_shards(hashes, n_dev, rows, bits, gpu) if rows else
              _ring_shards(kind, hashes, mesh, bits))
    sc = bm.filter_scalars(0.05, 21)[:3]
    radio = int(bm.filter_scalars(0.05, 21)[3])
    kinds = set()
    steps = de._n_ring_steps(n_dev)
    if kind == "bitmap":
        rows = shards[0].xp.shape[0]
        for cont, rd in ((False, radio), (True, 0)):
            slabs, counts, los = de.ring_slabs(mesh, shards, sc, rd, cont)
            for d in range(n_dev):
                ii, jj = de.ring_positions(slabs[d], counts[d], los[d])
                want_i, want_j = [], []
                for t in range(steps):
                    loc, vis = shards[d], shards[(d - t) % n_dev]
                    kinds.add(de._step_kind(t, n_dev, loc.lo, vis.lo))
                    ok = de.ring_filter_mask_plain(loc, vis, t, n_dev, sc,
                                                   rd, cont)
                    assert torch.equal(slabs[d][t],
                                       bm.pack_mask_u8(ok)), (d, t, cont)
                    assert int(counts[d][t]) == int(ok.sum()), (d, t, cont)
                    f = de.ring_bitmap_step_plain(
                        loc, vis, t, n_dev, sc, rd, cont).long().cpu().numpy()
                    want_i.append(loc.lo + f // rows)
                    want_j.append(vis.lo + f % rows)
                assert np.array_equal(ii, np.concatenate(want_i)), (d, cont)
                assert np.array_equal(jj, np.concatenate(want_j)), (d, cont)
    for d in range(n_dev if kind != "bitmap" else 0):
        for t in range(steps):
            loc, vis = shards[d], shards[(d - t) % n_dev]
            kinds.add(de._step_kind(t, n_dev, loc.lo, vis.lo))
            if kind == "edges":
                got = de.ring_edges_step(loc, vis, t, n_dev, radio)
                want = de.ring_edges_step_plain(loc, vis, t, n_dev, radio)
                assert torch.equal(got[0], want[0]), (d, t)
                assert torch.equal(got[1], want[1]), (d, t)
            else:
                rows = loc.xp.shape[0]
                got = torch.zeros((1, rows, rows // 8), dtype=torch.uint8,
                                  device=gpu)
                count = torch.zeros(1, dtype=torch.int32, device=gpu)
                de.ring_masks_step(loc, vis, t, n_dev, sc, radio, False, got,
                                   count)
                ok = de.ring_filter_mask_plain(loc, vis, t, n_dev, sc, radio,
                                               False)
                assert torch.equal(got[0], bm.pack_mask_u8(ok)), (d, t)
                assert int(count) == int(ok.sum()), (d, t)
    assert kinds == ({"self"} if n_dev == 1 else
                     {"self", "full"} if n_dev == 3 else
                     {"self", "full", "none"})


@pytest.mark.parametrize("base", [0, 4095, 1 << 20])
def test_ring_step_bound_is_exact_at_every_size(gpu, base):
    """The ring step's float32 bound at every boundary: all-zero
    signatures (shared 0), rows of size base + 1, column j of size j (size
    sums base + 1 .. base + 4096), row i with collisions c0 + i and the
    columns with more, so pair (i, j) passes iff c0 + i + 2 >
    jmin_num (base + 1 + j) / jmin_den in float32: the rows' thresholds
    cross every integer the quotient takes over the columns.  The kernel's
    division (two corrections of a reciprocal product) against the plain
    step's IEEE division, at two thresholds and k."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    rows = 4096
    x = torch.zeros((rows, 128), dtype=torch.uint8, device=gpu)
    ids = torch.arange(rows, dtype=torch.int32, device=gpu)
    vis = de.BitShard(x, ids + (1 << 23), ids, 0)
    for thr, k in ((0.05, 21), (0.3, 15)):
        sc = bm.filter_scalars(thr, k)
        c0 = max(0, int(np.floor(sc[0] * np.float32(base + 1) / sc[1])) - 2)
        loc = de.BitShard(x, ids + c0, torch.full_like(ids, base + 1), rows)
        out = torch.zeros((1, rows, rows // 8), dtype=torch.uint8, device=gpu)
        count = torch.zeros(1, dtype=torch.int32, device=gpu)
        de.ring_masks_step(loc, vis, 1, 3, sc[:3], 0, False, out, count)
        ok = de.ring_filter_mask_plain(loc, vis, 1, 3, sc[:3], 0, False)
        assert 0 < int(ok.sum()) < rows * (rows - 1)
        assert torch.equal(out[0], bm.pack_mask_u8(ok)), (thr, k)
        assert int(count) == int(ok.sum())


def test_bitmap_ring_syncs_only_at_its_close(gpu, monkeypatch):
    """``distributed_candidate_pairs_bitmap`` over [cuda:0] * 4 makes no
    host synchronisation from its first step until the closing pull
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one), and
    launches K3 once a shard, not once a step; its pairs equal the ring
    over CPU shards."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    hashes = _ring_corpus(n=600)
    step, close = de.ring_masks_step, de.ring_positions
    started = []

    def first_step(*args, **kwargs):
        if not started:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            started.append(True)
        step(*args, **kwargs)

    def closing_pull(*args, **kwargs):
        torch.cuda.set_sync_debug_mode(0)
        return close(*args, **kwargs)

    monkeypatch.setattr(de, "ring_masks_step", first_step)
    monkeypatch.setattr(de, "ring_positions", closing_pull)
    mesh = de.make_mesh(devices=[gpu] * 4)
    bm.reset_launches()
    de.reset_launches()
    try:
        got = de.distributed_candidate_pairs_bitmap(hashes, 0.05, 21,
                                                    mesh=mesh, bits=2048)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert started
    assert de.LAUNCHES["ring_bitmap"] == 4 * de._n_ring_steps(4) - 2
    assert bm.LAUNCHES["mask_compact"] == 4
    assert de.LAUNCHES["ring_masks"] == 0
    monkeypatch.undo()
    want = de.distributed_candidate_pairs_bitmap(
        hashes, 0.05, 21, mesh=de.make_mesh(devices=[torch.device("cpu")] * 4),
        bits=2048)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_bitmap_ring_close_off_the_current_device():
    """The bitmap ring with shards on cuda:1 while cuda:0 is current (a
    mesh over two cards, and one over cuda:1 alone): each shard's close
    runs K3, the counts' pull and the positions' copy on its slab's device
    and stream, so its pairs equal the ring over CPU shards.  Needs two
    GPUs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    hashes = _ring_corpus(n=3000)
    want = de.distributed_candidate_pairs_bitmap(
        hashes, 0.05, 21, mesh=de.make_mesh(devices=[torch.device("cpu")] * 2),
        bits=2048)
    assert len(want[0]) > 0
    for devices in ([0, 1], [1, 1]):
        with torch.cuda.device(0):
            got = de.distributed_candidate_pairs_bitmap(
                hashes, 0.05, 21, bits=2048, mesh=de.make_mesh(
                    devices=[torch.device("cuda", d) for d in devices]))
        for a, b in zip(got, want):
            assert np.array_equal(a, b), devices


def test_k3_scratch_one_a_stream(gpu):
    """K3 on the current stream and on a side stream, 20 launches each
    with no wait between the two: each stream has a scratch of its own
    (the ticket word and the epoch hold for one stream's order), and
    every output equals the plain version's.  Exact."""
    packs = _random_packs(gpu, 16, 1024, 0.01, seed=11)
    counts = _popcounts(packs)
    want = torch.empty(int(counts.sum()), dtype=torch.int32, device=gpu)
    bm.compact_masks_into_plain(packs, counts, want, want.numel())
    streams = (torch.cuda.current_stream(gpu), torch.cuda.Stream(gpu))
    streams[1].wait_stream(streams[0])
    scratch = []
    for stream in streams:
        with torch.cuda.stream(stream):
            scratch.append(bm.k3_scratch(gpu, 1 << 14))
    epochs = [s.epoch for s in scratch]
    outs = []
    for i in range(40):
        with torch.cuda.stream(streams[i % 2]):
            out = torch.full_like(want, -7)
            bm.compact_masks_into(packs, counts, out, out.numel())
            assert bm.k3_scratch(gpu, 1) is scratch[i % 2]
        outs.append(out)
    torch.cuda.synchronize()
    assert scratch[0] is not scratch[1]
    assert [s.epoch - e for s, e in zip(scratch, epochs)] == [20, 20]
    for i, out in enumerate(outs):
        assert torch.equal(out, want), i


def test_dist_lp_round_on_card_matches_plain(gpu):
    """One mesh LP round over 4 slabs on the card against the same round
    on CPU copies, with a clear list whose (step, row, byte) targets
    repeat."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    hashes = _ring_corpus(n=900)
    mesh = de.make_mesh(devices=[gpu] * 4)
    cpu_mesh = de.make_mesh(devices=[torch.device("cpu")] * 4)
    sc = bm.filter_scalars(0.05, 21)[:3]
    radio = int(bm.filter_scalars(0.05, 21)[3])
    slabs = de.build_ring_masks(mesh, _ring_shards("masks", hashes, mesh),
                                sc, radio, False)
    cpu_slabs = de.build_ring_masks(
        cpu_mesh, _ring_shards("masks", hashes, cpu_mesh), sc, radio, False)
    for a, b in zip(slabs, cpu_slabs):
        assert torch.equal(a.cpu(), b)
    rng = np.random.default_rng(2)
    clrs = [clear_list(s.cpu().numpy(), rng) for s in cpu_slabs]
    n_pad = 4 * slabs[0].shape[1]
    labels = rng.integers(0, 50, n_pad).astype(np.int32)
    got = de.dist_lp_round(mesh, slabs, {gpu: torch.from_numpy(labels).to(
        gpu)}, [torch.from_numpy(c).to(gpu) for c in clrs])
    cpu = torch.device("cpu")
    want = de.dist_lp_round(cpu_mesh, cpu_slabs,
                            {cpu: torch.from_numpy(labels)},
                            [torch.from_numpy(c) for c in clrs])
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    for a, b in zip(slabs, cpu_slabs):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n_dev", [3, 4])
def test_mesh_engines_on_card_match_cpu(gpu, n_dev):
    """The mesh functions over [cuda:0] * n_dev (3: an odd ring, no
    antipodal step) equal the same functions over CPU shards."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    hashes = _ring_corpus(n=420)
    mesh = de.make_mesh(devices=[gpu] * n_dev)
    cpu = de.make_mesh(devices=[torch.device("cpu")] * n_dev)
    de.reset_launches()
    for engine_name in ("exact", "bitmap"):
        got = de.distributed_mst(hashes, 0.05, 21, mesh=mesh,
                                 engine=engine_name, bits=2048)
        want = de.distributed_mst(hashes, 0.05, 21, mesh=cpu,
                                  engine=engine_name, bits=2048)
        for a, b in zip(got.mst, want.mst):
            assert np.array_equal(a, b), engine_name
    assert de.distributed_threshold_clusters(
        hashes, 0.05, 21, mesh=mesh, bits=2048) == \
        de.distributed_threshold_clusters(hashes, 0.05, 21, mesh=cpu,
                                          bits=2048)
    for a, b in zip(de.distributed_similarity_graph(hashes, 0.05, 21,
                                                    mesh=mesh, bits=2048),
                    de.distributed_similarity_graph(hashes, 0.05, 21,
                                                    mesh=cpu, bits=2048)):
        assert np.array_equal(a, b)
    assert de.distributed_threshold_clusters_lp(
        hashes, 0.05, 21, mesh=mesh, bits=2048) == \
        de.distributed_threshold_clusters_lp(hashes, 0.05, 21, mesh=cpu,
                                             bits=2048)
    steps = n_dev * de._n_ring_steps(n_dev) - (n_dev // 2 if n_dev % 2 == 0
                                               else 0)
    assert de.LAUNCHES["ring_edges"] == steps
    assert de.LAUNCHES["ring_bitmap"] == 3 * steps
    assert de.LAUNCHES["ring_masks"] == steps
    assert de.LAUNCHES["dist_lp_round"] >= n_dev


def test_shard_moved_to_the_card_carries_its_compact_form(gpu):
    """``PlaneShard.to`` onto another device copies the compact form built
    where the shard lives; K4's and K5b's wrappers then read that copy."""
    from dataclasses import fields

    from rabbittclust_tpu_torch.ops.pack import compact_of, compact_planes
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    _, pk, _ = _planes(300, 150, False, torch.device("cpu"))
    shard = de.PlaneShard(torch.from_numpy(pk.plane0.view(np.int32)), None,
                          torch.from_numpy(pk.sizes.astype(np.int32)), 0)
    home = compact_of(shard.p0, None)
    moved = shard.to(gpu)
    form = compact_of(moved.p0, None)
    fresh = compact_planes(moved.p0, None)
    assert form is not home and form.g0.device == moved.p0.device
    for f in fields(fresh):
        a, b = getattr(form, f.name), getattr(fresh, f.name)
        assert (a is None and b is None) or (
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


def test_mesh_rejects_a_shard_past_k2_before_the_build(gpu):
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    hashes = [np.arange(5, dtype=np.uint32)] * (lp.MAX_RB + 1)
    with pytest.raises(ValueError, match="shard"):
        de.distributed_threshold_clusters_lp(
            hashes, 0.05, 21, mesh=de.make_mesh(devices=[gpu]), bits=128)


def test_mesh_cli_on_card_equals_dense_engine(gpu, tmp_path, monkeypatch):
    """RTC_MESH=1 clust-mst --fast --device --presketched on the card (a
    1-shard exact ring: one device is visible) writes the edge.mst and
    .cluster of the dense engine (RTC_MESH=0)."""
    import os
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    hashes = _ring_corpus(n=400)
    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("RTC_MESH", mode)
        wd = tmp_path / f"mesh{mode}"
        wd.mkdir()
        monkeypatch.chdir(wd)
        folder, _ = _kssd_folder(wd, hashes)
        de.reset_launches()
        assert main(["--fast", "--device", "--presketched", folder, "-o",
                     str(wd / "o.cluster")], device=gpu) == 0
        assert (de.LAUNCHES["ring_edges"] > 0) == (mode == "1")
        # a --presketched run saves edge.mst into its folder
        outs[mode] = (wd / "o.cluster", os.path.join(folder, "edge.mst"))
    for a, b in zip(outs["0"], outs["1"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)


def _ulp_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """The two stats' minima, float32 bits as int32, apart in ulp."""
    return abs(int(a[1]) - int(b[1]))


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_ring_stats_steps_match_plain(gpu, n_dev):
    """Every (device, step) of the stats ring over [cuda:0] * n_dev: K4's
    stats mode (tile kinds self / full / none) against the plain step (the
    JAX ownership mask on genome ids): the count equal, the float32
    minimum within 4 ulp; then distributed_candidate_stats against CPU
    shards."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    mesh = de.make_mesh(devices=[gpu] * n_dev)
    hashes = _ring_corpus(n=300)
    shards = _ring_shards("edges", hashes, mesh)
    radio = de.size_ratio_limit(0.05, 20)
    kinds = set()
    before = de.LAUNCHES["ring_stats"]
    for d in range(n_dev):
        for t in range(de._n_ring_steps(n_dev)):
            loc, vis = shards[d], shards[(d - t) % n_dev]
            kinds.add(de._step_kind(t, n_dev, loc.lo, vis.lo))
            got = de.ring_stats_step(loc, vis, t, n_dev, 0.05, 21, radio)
            want = de.ring_stats_step_plain(loc, vis, t, n_dev, 0.05, 21,
                                            radio)
            assert int(got[0]) == int(want[0]), (d, t)
            assert _ulp_apart(got, want) <= 4, (d, t)
    assert kinds == ({"self"} if n_dev == 1 else
                     {"self", "full"} if n_dev == 3 else
                     {"self", "full", "none"})
    assert de.LAUNCHES["ring_stats"] - before == n_dev * de._n_ring_steps(
        n_dev) - (n_dev // 2 if n_dev % 2 == 0 else 0)
    p0, _, sz = de._pack_rows_for_mesh(hashes, mesh)
    got = de.distributed_candidate_stats(p0, sz, 0.05, 21, mesh=mesh)
    want = de.distributed_candidate_stats(
        p0, sz, 0.05, 21, mesh=de.make_mesh(devices=[torch.device("cpu")] *
                                            n_dev))
    assert got[0] == want[0]
    assert abs(int(np.float32(got[1]).view(np.int32)) -
               int(np.float32(want[1]).view(np.int32))) <= 4


@pytest.mark.parametrize("rows", [96, 160, 4096])
def test_stats_mode_matches_plain(gpu, rows):
    """K4's stats mode on two shards of ``rows`` genomes each (padded on the
    card to a multiple of 128 with size-0 rows): the self tile (rows
    against themselves, j < i), the full tile (columns from the other
    shard's compact form) and the antipodal step's empty tile, against
    ``pair_stats_tiles_plain`` and the plain ring step."""
    from rabbittclust_tpu_torch.parallel import dist_engine as de
    mesh = de.make_mesh(devices=[gpu] * 2)
    hashes = _ring_corpus(n=2 * rows)
    shards = _ring_shards("edges", hashes, mesh)
    lo_shard, hi_shard = shards
    assert lo_shard.p0.shape[0] % 128 == 0
    assert int(lo_shard.sizes[rows:].abs().sum()) == 0
    radio = de.size_ratio_limit(0.05, 20)
    for loc, vis, t in ((hi_shard, hi_shard, 0), (hi_shard, lo_shard, 1),
                        (lo_shard, hi_shard, 1)):
        kind = de._step_kind(t, 2, loc.lo, vis.lo)
        n_rows = loc.p0.shape[0]
        got = ix.pair_stats_tiles(loc.p0, loc.sizes, [0], [0],
                                  [int(kind != "none")], radio, 0.05, 21,
                                  n_rows, cols=(vis.p0, vis.sizes),
                                  tri=kind == "self")
        want = ix.pair_stats_tiles_plain(
            loc.p0, loc.sizes, [0], [0], [int(kind != "none")], radio, 0.05,
            21, n_rows, cols=(vis.p0, vis.sizes), tri=kind == "self")
        step = de.ring_stats_step_plain(loc, vis, t, 2, 0.05, 21, radio)
        assert int(got[0]) == int(want[0]) == int(step[0]), kind
        assert _ulp_apart(got, want) <= 4 and _ulp_apart(got, step) <= 4
    with pytest.raises(ValueError, match="multiple of 128"):
        ix.pair_stats_tiles(lo_shard.p0, lo_shard.sizes, [0], [0], [1],
                            radio, 0.05, 21, 96)


def test_two_process_sim_on_the_card():
    """Two processes of two shards each on cuda:0: the ranks share the
    card, so the ring's hop is staged through host memory over gloo; each
    child holds its results to the port's single-process engines."""
    from rabbittclust_tpu_torch.parallel.multihost import launch_local_sim
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    outs = launch_local_sim(2, 2, 48, device="cuda", timeout=600)
    assert all(o.startswith("OK proc=") and "transport=gloo-staged" in o
               for o in outs), outs
    assert len({o.split("digest=")[1] for o in outs}) == 1
    assert all(int(o.split("ring_launches=")[1].split()[0]) > 0
               for o in outs)


# ---------------------------------------------------------------------------
# The state files' device paths: the RepDB probe and the MinHash append

@pytest.mark.parametrize("pull", ["mask", "idx"])
def test_batch_query_device_on_card_matches_serial(gpu, monkeypatch, pull):
    """``batch_query_device`` on cuda:0 (K1, and K3 under idx) equals the
    serial ``query_topk`` loop field for field, distances exactly."""
    from rabbittclust_tpu_torch.cluster.greedy import greedy_cluster
    from rabbittclust_tpu_torch.sketch.base import SketchSet
    from rabbittclust_tpu_torch.sketch.kssd import KssdParams
    from rabbittclust_tpu_torch.state.greedy_state import (
        KssdClusterState, batch_query_device)
    monkeypatch.setenv("RTC_PULL_MODE", pull)
    hashes = clustered_sketches(n=600, s=400, n_clusters=150, seed=17)
    p = KssdParams.from_kmer_size(21, 3)
    ss = SketchSet("kssd", p, True, False)
    for i, h in enumerate(hashes[:400]):
        ss.append_genome(file_name=f"g{i}.fna", name=f"g{i}", comment="",
                         seq0_len=1, total_len=1, num_seqs=1, hashes=h)
    ss2 = ss.reorder(ss.kssd_greedy_order())
    st = KssdClusterState.from_clustering(
        ss2, p, greedy_cluster(ss2.hashes, 0.05, p.kmer_size,
                               presorted=True), 0.05)
    rng = np.random.default_rng(2)
    reps = [st.hashes[g] for g in st.representative_ids]
    novel = clustered_sketches(n=8, s=400, n_clusters=8, seed=99)
    queries = hashes[400:] + novel + [
        np.union1d(a[rng.random(len(a)) < 0.7], b[rng.random(len(b)) < 0.7])
        for a, b in zip(reps[0::2], reps[1::2])]
    bm.reset_launches()
    got = batch_query_device(st, queries, 3, device=gpu)
    torch.cuda.synchronize()
    assert bm.LAUNCHES["filter_mask"] > 0
    assert (bm.LAUNCHES["mask_compact"] > 0) == (pull == "idx")
    assert got == [st.query_topk(q, 3) for q in queries]
    assert any(len(r) > 1 for r in got) and any(not r for r in got)


def test_minhash_classic_append_on_card_matches_native(gpu, tmp_path,
                                                       monkeypatch):
    """MinHash ``clust-mst --device --append`` over a folder without a
    state: K4's mask mode on two planes from start_index, and the new
    folder's MST equal to the native ``compute_mst`` with the same
    start_index and the saved edges (edges equal, weights to 1e-12)."""
    from rabbittclust_tpu_torch.cli.clust_mst import main
    from rabbittclust_tpu_torch.io.fasta import read_file_list
    from rabbittclust_tpu_torch.sketch.minhash import sketch_files_minhash
    from rabbittclust_tpu_torch.state import sketch_io
    files, _ = _write_genomes(tmp_path, 4, 4, 20_000, 12)
    lists = {}
    for name, part in (("build", files[:10]), ("add", files[10:])):
        lists[name] = str(tmp_path / f"{name}.list")
        with open(lists[name], "w") as f:
            f.write("\n".join(part) + "\n")
    for wd in ("src", "app"):
        (tmp_path / wd).mkdir()
    monkeypatch.chdir(tmp_path / "src")
    args = ["--device", "-l", "-d", "0.05", "-m", "1000", "-s", "300"]
    assert main(args + ["-i", lists["build"], "-o", "src.cluster"]) == 0
    (src,) = [p for p in (tmp_path / "src").iterdir() if p.is_dir()]
    calls = []
    real = engine.pair_mask_tiles

    def spy(*a, **kw):
        calls.append((a[1] is not None, a[7]))
        return real(*a, **kw)
    monkeypatch.setattr(engine, "pair_mask_tiles", spy)
    monkeypatch.chdir(tmp_path / "app")
    ix.reset_launches()
    assert main(args + ["--presketched", str(src), "--append",
                        lists["add"], "-o", "app.cluster"]) == 0
    torch.cuda.synchronize()
    assert ix.LAUNCHES["pair_mask_tiles"] > 0 and set(calls) == {(True, 10)}
    (new,) = [p for p in (tmp_path / "app").iterdir() if p.is_dir()]
    ss, p = sketch_io.load_minhash_sketches(str(src))
    ss.extend(sketch_files_minhash(read_file_list(lists["add"]), 1000, p))
    want = compute_mst(ss.hashes, 0.05, p.kmer_size, start_index=10,
                       pre_edges=sketch_io.load_mst(str(src))).mst
    got = sketch_io.load_mst(str(new))
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=0)
    assert len(_cluster_ids(str(tmp_path / "app" / "app.cluster"))) == 4


def _trace_kernels(path):
    """Names of the device kernels in one Chrome trace of torch.profiler."""
    import json
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events
            if e.get("cat") == "kernel"]


def test_maybe_trace_holds_k1(gpu, tmp_path, monkeypatch):
    """RTC_PROFILE_DIR around one K1 launch: one JSON trace in the phase's
    directory, with K1's kernel on its device timeline."""
    from rabbittclust_tpu_torch.utils.profiling import maybe_trace
    hashes = clustered_sketches(n=300)
    sig = _signatures(hashes, 1024, 128, gpu)
    sc = bm.filter_scalars(0.05, 21)
    monkeypatch.setenv("RTC_PROFILE_DIR", str(tmp_path / "prof"))
    before = bm.LAUNCHES["filter_mask"]
    with maybe_trace("k1 phase", gpu) as trace:
        bm.batched_mask(sig.xd, sig.cd, sig.sd, *TILES, *sc, False, 128)
        torch.cuda.synchronize()
    assert bm.LAUNCHES["filter_mask"] == before + 1
    assert os.listdir(tmp_path / "prof") == ["k1_phase"]
    assert os.path.dirname(trace.path) == str(tmp_path / "prof" /
                                              "k1_phase")
    names = _trace_kernels(trace.path)
    assert any("filter_mask_kernel" in n for n in names), names[:20]


def test_mst_free_t1_on_card_equals_cpu(gpu, tmp_path, monkeypatch):
    """``clust-mst --fast -l --device -e -t 1`` at 400 genomes (the scale
    corpus's parameters) under RTC_CLUSTER_BITS=2048, RTC_CLUSTER_RB=256:
    the card's run launches K1 and writes the CPU run's bytes."""
    from rabbittclust_tpu_torch.cli.clust_mst import main
    lst = write_scale_genomes(str(tmp_path))
    monkeypatch.setenv("RTC_CLUSTER_BITS", "2048")
    monkeypatch.setenv("RTC_CLUSTER_RB", "256")
    monkeypatch.delenv("RTC_MST_CLUSTERS_FAST", raising=False)
    outs = {}
    for side, dev in (("cpu", torch.device("cpu")), ("card", gpu)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        bm.reset_launches()
        outs[side] = tmp_path / side / "o.cluster"
        assert main(["--fast", "-l", "-i", lst, "-d", "0.05", "--drlevel",
                     "2", "-k", "21", "-e", "--device", "-t", "1", "-o",
                     str(outs[side])], device=dev) == 0
        launched = bm.LAUNCHES["filter_mask"]
        assert (launched > 0) == (side == "card"), (side, launched)
    assert outs["card"].read_bytes() == outs["cpu"].read_bytes()
    assert outs["card"].read_text().count("the cluster") == 20

"""The bitmap ring's slab form and K1's triangular grid on the CPU.

The bitmap ring (``parallel/dist_engine.py::ring_slabs`` then
``ring_positions``) fills each shard's slab of packed masks and its counts,
and compacts after the last step; on CPU shards it must give the JAX
package's ``distributed_candidate_pairs_bitmap`` element for element, and
each step of the slab must be the plain step's mask.  The lower-triangle
block list (``ops/bitmap.py::tri_block``, the map of K1's triangular
grid, launched by a ring's self step and K6's triangular mode) is host
arithmetic, checked here against brute force, as is the tile walk of
the ring step's own kernel (``ring_tiles``, ``ring_cta_tiles``).  Every
comparison is exact."""

import numpy as np
import pytest
import torch

from rabbittclust_tpu.parallel import dist_engine as jde
from rabbittclust_tpu_torch.ops import bitmap as bm
from rabbittclust_tpu_torch.parallel import dist_engine as pde
from torch_port_data import clustered_sketches

CPU = torch.device("cpu")


@pytest.mark.parametrize("rows,cols", [(128, 128), (200, 200), (2048, 2048),
                                       (4096, 4096), (2048, 1000),
                                       (300, 700)])
def test_lower_blocks_are_the_blocks_with_pairs(rows, cols):
    """The blocks K1's triangular grid launches are exactly the 128²
    blocks holding some pair j < i (positions from equal origins), each
    once, row by row."""
    nbx, nby = -(-cols // 128), -(-rows // 128)
    got = [bm.tri_block(k, nbx, nby) for k in range(bm.tri_count(nbx, nby))]
    want = [(by, bx) for by in range(nby) for bx in range(nbx)
            if 128 * bx < min(128 * by + 127, rows - 1)]
    assert got == want


@pytest.mark.parametrize("rows", [96, 160, 4000, 4096, 16384])
@pytest.mark.parametrize("tri", [True, False], ids=["self", "full"])
def test_ring_step_tiles_cover_each_pair_once(rows, tri):
    """The ring step's kernel (``csrc/ring_step.cu``) walks tiles of
    ``RING_TILE`` = 128 x 256 pairs over a persistent grid: every pair
    (i, j) of a rows x rows step lies in exactly one visited tile (on a
    self step every pair with j < i, and no tile is visited that holds
    none), and the CTAs' walks (132 of them, an H100's SMs, and 7) split
    the walk without a gap or an overlap."""
    bm_, bn = bm.RING_TILE
    tiles = bm.ring_tiles(rows, rows, tri)
    assert len(set(tiles)) == len(tiles)
    for grid in (132, 7):
        walks = [bm.ring_cta_tiles(rows, rows, tri, grid, c)
                 for c in range(min(grid, len(tiles)))]
        assert walks == [tiles[c::grid] for c in range(len(walks))]
        assert sorted(t for w in walks for t in w) == sorted(tiles)
    # pairs covered a row: the union of the row block's column ranges
    for by in range(-(-rows // bm_)):
        cols = sorted(bx for y, bx in tiles if y == by)
        assert cols == list(range(len(cols)))  # disjoint, from column 0
        last = min(by * bm_ + bm_, rows) - 1  # the block's last row
        covered = min(len(cols) * bn, rows)
        if tri:  # every j < last, and each tile starts below last
            assert covered >= last and all(bx * bn < last for bx in cols)
        else:
            assert covered == rows
    if rows <= 160:  # brute force: each pair's count of visiting tiles
        hits = np.zeros((rows, rows), dtype=np.int64)
        for by, bx in tiles:
            hits[by * bm_:(by + 1) * bm_, bx * bn:(bx + 1) * bn] += 1
        want = np.tril(np.ones((rows, rows), dtype=bool), -1) if tri \
            else np.ones((rows, rows), dtype=bool)
        assert (hits[want] == 1).all() and hits.max() == 1


def _disjoint(n=96, s=120, seed=4):
    """Independent random sketches: no pair shares enough bits to pass."""
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, 2 ** 31, s).astype(np.uint32))
            for _ in range(n)]


CORPORA = {"clustered": lambda: clustered_sketches(
               n=150, s=120, n_clusters=9, seed=17, keep=0.8),
           "all_empty": _disjoint}


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("k", [2, 4, 8])
def test_slab_ring_equals_jax(k, corpus):
    """Each shard's slab holds the plain step's packed mask and count at
    every step; the shard's close gives the plain steps' positions in
    step order; the whole candidate list equals JAX's."""
    hashes = CORPORA[corpus]()
    n = len(hashes)
    bits = 1024
    mesh = pde.make_mesh(devices=[CPU] * k)
    want = jde.distributed_candidate_pairs_bitmap(
        hashes, 0.05, 21, mesh=jde.make_mesh(k), bits=bits)
    got = pde.distributed_candidate_pairs_bitmap(hashes, 0.05, 21,
                                                 mesh=mesh, bits=bits)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    if corpus == "all_empty":
        assert len(got[0]) == 0

    xp, coll = bm.pack_bitmaps_packed(hashes, bits=bits, pad_n_to=k)
    sizes = np.zeros(xp.shape[0], dtype=np.int32)
    sizes[:n] = [len(h) for h in hashes]
    shards = pde._bit_shards(xp, coll, sizes, mesh)
    sc = bm.filter_scalars(0.05, 21)
    scalars, radio = sc[:3], int(sc[3])
    slabs, counts, los = pde.ring_slabs(mesh, shards, scalars, radio, False)
    rows = shards[0].xp.shape[0]
    assert rows % 8 == 0
    for d in range(k):
        ii, jj = pde.ring_positions(slabs[d], counts[d], los[d])
        want_i, want_j = [], []
        for t in range(pde._n_ring_steps(k)):
            loc, vis = shards[d], shards[(d - t) % k]
            assert los[d][t] == (loc.lo, vis.lo)
            ok = pde.ring_filter_mask_plain(loc, vis, t, k, scalars, radio,
                                            False)
            assert torch.equal(slabs[d][t], bm.pack_mask_u8(ok)), (d, t)
            assert int(counts[d][t]) == int(ok.sum()), (d, t)
            f = pde.ring_bitmap_step_plain(loc, vis, t, k, scalars, radio,
                                           False).long().numpy()
            want_i.append(loc.lo + f // rows)
            want_j.append(vis.lo + f % rows)
        assert np.array_equal(ii, np.concatenate(want_i)), d
        assert np.array_equal(jj, np.concatenate(want_j)), d
